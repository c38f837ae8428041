"""Wavefront (windowed, deduplicated) sampler: unit + render parity tests.

The wavefront path (grid/wavefront.py + ops/geodesic.windowed_reduce) must
produce BIT-IDENTICAL images to the per-step scan path: it reuses the same
locate/trilinear/fallback helpers and only restructures when the packed
columns are fetched from HBM.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blacklight import read_config
from blacklight.grid.wavefront import (
    _split_bf16x3, build_window_tables, expand_onehot, gather_window_columns)


def render_pair(fixtures_dir, name, _variants=((False, True), (True, True)),
                **overrides):
    """Render the same config across (wavefront, wavefront_batch) variants."""
    from blacklight.pipeline_simulation import make_simulation_renderer

    images = []
    for wf, batch in _variants:
        cfg = read_config(str(fixtures_dir / name))
        cfg.simulation_file = str(fixtures_dir / "mock_small.athdf")
        for k, v in overrides.items():
            setattr(cfg, k, v)
        render_fn, geom, rays, freqs, mass = make_simulation_renderer(
            cfg, wavefront=wf, wavefront_batch=batch)
        images.append(render_fn(rays.positions, rays.directions,
                                rays.momentum_factors))
    return images


def test_build_window_tables_roundtrip():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 5000, size=(64, 32)).astype(np.int32)
    tables, local, overflow = jax.jit(
        build_window_tables, static_argnums=(1, 2))(ids, 4, 1024)
    assert not bool(overflow)
    tables, local = np.asarray(tables), np.asarray(local)
    # Every sample's table slot holds its own cell id
    bs = 64 // 4
    for s in range(4):
        got = tables[s][local[s * bs:(s + 1) * bs]]
        np.testing.assert_array_equal(got, ids[s * bs:(s + 1) * bs])
        n_unique = len(np.unique(ids[s * bs:(s + 1) * bs]))
        np.testing.assert_array_equal(np.sort(np.unique(tables[s]))[:n_unique],
                                      np.unique(ids[s * bs:(s + 1) * bs]))


def test_build_window_tables_overflow_flag():
    ids = np.arange(32 * 8, dtype=np.int32).reshape(32, 8)  # 256 unique
    _, _, overflow = jax.jit(
        build_window_tables, static_argnums=(1, 2))(ids, 1, 128)
    assert bool(overflow)
    _, _, overflow = jax.jit(
        build_window_tables, static_argnums=(1, 2))(ids, 1, 256)
    assert not bool(overflow)


def test_expand_onehot_bit_exact():
    """One-hot MXU expansion == direct indexing, bit for bit, for values in
    the exact-split domain."""
    rng = np.random.default_rng(7)
    n_sub, cap, p, bs = 2, 256, 64, 128
    vals = (rng.standard_normal((n_sub, cap, p))
            * 10.0 ** rng.uniform(-20, 15, (n_sub, cap, p))).astype(np.float32)
    local = rng.integers(0, cap, size=(n_sub, bs)).astype(np.int32)
    got = np.asarray(expand_onehot(_split_bf16x3(jnp.asarray(vals)),
                                   jnp.asarray(local), cap))
    want = np.stack([vals[s, local[s]] for s in range(n_sub)])  # (n_sub,bs,p)
    want = want.reshape(n_sub * bs, p).T
    np.testing.assert_array_equal(got, want)


def test_gather_window_columns_layout():
    rng = np.random.default_rng(11)
    packed = rng.standard_normal((8, 100)).astype(np.float32)
    tables = rng.integers(0, 100, size=(3, 5)).astype(np.int32)
    out = np.asarray(gather_window_columns(jnp.asarray(packed),
                                           jnp.asarray(tables)))
    assert out.shape == (3, 5, 8)
    for s in range(3):
        for r in range(5):
            np.testing.assert_array_equal(out[s, r], packed[:, tables[s, r]])


@pytest.mark.parametrize("interp", [True, False])
def test_wavefront_render_parity(fixtures_dir, interp):
    """Wavefront image == per-step-scan image bit for bit (f64 CPU path,
    gather expansion)."""
    img_wf_off, img_wf_on = render_pair(
        fixtures_dir, "golden_sim_rk4_32.input", simulation_interp=interp,
        image_time=True, image_tau=True)
    assert set(img_wf_on) == set(img_wf_off)
    for k in img_wf_off:
        np.testing.assert_array_equal(img_wf_on[k], img_wf_off[k],
                                      err_msg=k)


def test_wavefront_render_parity_f32(fixtures_dir):
    """f32 grid routes the expansion through the exact one-hot MXU matmul
    (bf16x3 split); still bit-identical to the per-step scan."""
    img_wf_off, img_wf_on = render_pair(
        fixtures_dir, "golden_sim_rk4_32.input", precision="float32")
    for k in img_wf_off:
        np.testing.assert_array_equal(img_wf_on[k], img_wf_off[k],
                                      err_msg=k)


def test_wavefront_batched_coeffs_bit_exact(fixtures_dir):
    """Window-batched coefficient evaluation (vmapped (W, B) chain in the
    window prep) == per-step evaluation inside the scan, bit for bit,
    including the aux planes that route through cell_fn."""
    img_unbatched, img_batched = render_pair(
        fixtures_dir, "golden_sim_rk4_32.input",
        _variants=((True, False), (True, True)),
        image_emission=True, image_tau=True, image_emission_ave=True)
    assert set(img_batched) == set(img_unbatched)
    for k in img_unbatched:
        np.testing.assert_array_equal(img_batched[k], img_unbatched[k],
                                      err_msg=k)


def test_build_brick_tables_roundtrip():
    """Brick slots address the same cells the anchors name; overflow fires
    exactly when a used anchor leaves its subtile's brick."""
    from blacklight.grid.wavefront import (build_brick_tables,
                                               fetch_brick_columns)

    rng = np.random.default_rng(5)
    w, b, n_sub = 6, 8, 2
    dims = (16, 12, 20)  # (n_k, n_j, n_i)
    brick = (4, 4, 8)
    k_m = rng.integers(2, 5, (w, b)).astype(np.int32)
    j_m = rng.integers(3, 6, (w, b)).astype(np.int32)
    i_m = rng.integers(5, 12, (w, b)).astype(np.int32)
    # Second subtile lives in a different corner of the grid
    k_m[:, b // 2:] += 8
    use = np.ones((w, b), dtype=bool)
    origins, slot, overflow = build_brick_tables(
        jnp.asarray(i_m), jnp.asarray(j_m), jnp.asarray(k_m),
        jnp.asarray(use), n_sub, dims, brick)
    assert not bool(overflow)
    n_k, n_j, n_i = dims
    packed = rng.standard_normal(
        (3, n_k * n_j * n_i)).astype(np.float32)
    tables = np.asarray(fetch_brick_columns(
        jnp.asarray(packed), origins, brick, dims))  # (n_sub, cap, P)
    slot = np.asarray(slot)
    bs = b // n_sub
    for s in range(n_sub):
        for step in range(w):
            for r in range(bs):
                col = b_col = s * bs + r
                flat = (k_m[step, col] * n_j + j_m[step, col]) * n_i \
                    + i_m[step, col]
                np.testing.assert_array_equal(
                    tables[s, slot[step, s, r]], packed[:, flat])
    # Pushing one used anchor outside its brick flags overflow; flagging
    # it unused suppresses that
    i_bad = i_m.copy()
    i_bad[0, 0] = i_m.min() + 9
    _, _, overflow = build_brick_tables(
        jnp.asarray(i_bad), jnp.asarray(j_m), jnp.asarray(k_m),
        jnp.asarray(use), n_sub, dims, brick)
    assert bool(overflow)
    use2 = use.copy()
    use2[0, 0] = False
    _, _, overflow = build_brick_tables(
        jnp.asarray(i_bad), jnp.asarray(j_m), jnp.asarray(k_m),
        jnp.asarray(use2), n_sub, dims, brick)
    assert not bool(overflow)


@pytest.mark.parametrize("interp", [True, False])
def test_wavefront_brick_render_parity(fixtures_dir, monkeypatch, interp):
    """Brick-mode wavefront image == per-step-scan image bit for bit."""
    from blacklight import pipeline_simulation

    monkeypatch.setattr(pipeline_simulation, "WAVEFRONT_MODE", "brick")
    img_wf_off, img_wf_on = render_pair(
        fixtures_dir, "golden_sim_rk4_32.input", simulation_interp=interp,
        image_time=True, image_tau=True)
    assert set(img_wf_on) == set(img_wf_off)
    for k in img_wf_off:
        np.testing.assert_array_equal(img_wf_on[k], img_wf_off[k],
                                      err_msg=k)


def test_wavefront_brick_render_parity_f32(fixtures_dir, monkeypatch):
    from blacklight import pipeline_simulation

    monkeypatch.setattr(pipeline_simulation, "WAVEFRONT_MODE", "brick")
    img_wf_off, img_wf_on = render_pair(
        fixtures_dir, "golden_sim_rk4_32.input", precision="float32")
    for k in img_wf_off:
        np.testing.assert_array_equal(img_wf_on[k], img_wf_off[k],
                                      err_msg=k)


def test_wavefront_brick_overflow_falls_back(fixtures_dir, monkeypatch):
    """A brick too small for the bundle's spread must not corrupt the
    image: overflow triggers the exact-path re-render."""
    from blacklight import pipeline_simulation

    monkeypatch.setattr(pipeline_simulation, "WAVEFRONT_MODE", "brick")
    monkeypatch.setattr(pipeline_simulation, "WAVEFRONT_BRICK", (1, 1, 2))
    img_wf_off, img_wf_on = render_pair(fixtures_dir,
                                        "golden_sim_rk4_32.input")
    for k in img_wf_off:
        np.testing.assert_array_equal(img_wf_on[k], img_wf_off[k],
                                      err_msg=k)


def test_wavefront_overflow_falls_back(fixtures_dir, monkeypatch):
    """A capacity too small for the bundle's working set must not corrupt
    the image: the overflow flag triggers a transparent exact-path
    re-render."""
    from blacklight import pipeline_simulation

    monkeypatch.setattr(pipeline_simulation, "WAVEFRONT_CAPACITY", 8)
    img_wf_off, img_wf_on = render_pair(fixtures_dir,
                                        "golden_sim_rk4_32.input")
    for k in img_wf_off:
        np.testing.assert_array_equal(img_wf_on[k], img_wf_off[k],
                                      err_msg=k)
