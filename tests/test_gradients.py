"""Differentiability tests: AD vs finite differences, NaN robustness.

New capability over the reference (nothing in the C++ is differentiable):
pixel intensities are differentiable with respect to emission-model
parameters, the GRMHD fields, and the camera rays - including configs where
rays die early, go optically thick, or leave the grid (all of which
produce by-design forward NaNs that must not leak into reverse-mode).
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "scripts"))
sys.path.insert(0, str(pathlib.Path(__file__).parent))

from test_adaptive import CONFIG  # noqa: E402

from blacklight import pipeline  # noqa: E402
from blacklight.camera import make_camera  # noqa: E402
from blacklight.models import formula as formula_model  # noqa: E402
from blacklight.transfer.unpolarized import (  # noqa: E402
    ImageOptions, integrate_unpolarized)
from blacklight.utils.config import parse_config  # noqa: E402


@pytest.fixture(scope="module")
def formula_setup(tmp_path_factory):
    cfg = parse_config(CONFIG.format(
        out=str(tmp_path_factory.mktemp("grad") / "o.npz"),
        res=4, max_level=0, num_regions=0, regions=""))
    bh_m, bh_a, mass_msun = pipeline.bh_mass_spin(cfg)
    geom, rays, freqs = make_camera(cfg, bh_m=bh_m, bh_a=bh_a)
    params = pipeline.geodesic_params_from_config(cfg, bh_m, bh_a)
    fparams = formula_model.formula_params_from_config(cfg)
    return cfg, geom, rays, freqs, params, fparams, mass_msun


def make_loss(setup, param="cn0", base=None):
    """Total flux as a function of one formula parameter and the camera
    positions, around `base` (default: the setup's parameters)."""
    cfg, geom, rays, freqs, params, fparams, mass_msun = setup
    base = fparams if base is None else base

    def loss(value, pos):
        fp = dataclasses.replace(base, **{param: value})

        def coeff_fn(p, k):
            j, alpha, _, bad = formula_model.formula_coefficients(
                p, k, rays.momentum_factors, freqs, fp, geom.cam_x)
            return j, alpha, bad

        img = integrate_unpolarized(
            pos, rays.directions, rays.momentum_factors, freqs,
            params=params, coeff_fn=coeff_fn,
            opts=ImageOptions(fallback_nan=False),
            mass_msun=mass_msun, camera_x=geom.cam_x,
            log_j_scale=formula_model.formula_log_j_scale(fp))
        return jnp.nansum(img["I_nu"])

    return loss


@pytest.mark.parametrize("param", ["cn0", "r0", "h"])
def test_formula_fit_gradient_matches_fd(formula_setup, param):
    """Reverse-mode AD through the scan of total flux wrt each fit
    parameter (emission amplitude, disk radius and thickness) matches
    central finite differences - at the FULL step count, where rays die
    long before the scan ends (the historical NaN-through-select regime).
    The h case starts from a thick disk: h = 0 zeroes its gradient."""
    cfg, geom, rays, freqs, params, fparams, mass_msun = formula_setup
    base = dataclasses.replace(fparams, h=0.4) if param == "h" else fparams
    loss = make_loss(formula_setup, param=param, base=base)
    x0 = getattr(base, param)
    f = jax.jit(lambda x: loss(x, rays.positions))
    g = jax.jit(jax.grad(lambda x: loss(x, rays.positions)))(jnp.asarray(x0))
    eps = x0 * 1e-4
    fd = (f(jnp.asarray(x0 + eps)) - f(jnp.asarray(x0 - eps))) / (2 * eps)
    assert np.isfinite(g) and float(g) != 0.0
    np.testing.assert_allclose(float(g), float(fd), rtol=1e-3)


def test_formula_coefficients_finite_on_axis(formula_setup):
    """On the rotation axis the reference divides by sin(theta) = 0 and its
    pixel turns NaN: such samples are flagged bad with finite values and
    finite gradients. Just off the axis, float32 keeps sin(theta) accurate
    (1 - (z/r)^2 rounds to 0 within ~3e-4 r of the axis), so float32
    samples there agree with float64 instead of being flagged."""
    cfg, geom, rays, freqs, params, fparams, mass_msun = formula_setup
    fp = dataclasses.replace(fparams, a_param=1.0, h=0.4)
    z = np.linspace(2.0, 40.0, 64)
    offsets = {"axis": 0.0, "near": 1e-5}

    def coeffs(dtype, offset, cn0):
        pos = jnp.stack([jnp.zeros(64), offset * z, 0.5 * offset * z, z],
                        axis=-1).astype(dtype)
        kcov = jnp.broadcast_to(jnp.array([-1.0, 0.3, 0.2, 0.1], dtype),
                                pos.shape)
        return formula_model.formula_coefficients(
            pos, kcov, jnp.ones(64, dtype), jnp.asarray(freqs, dtype),
            dataclasses.replace(fp, cn0=cn0), jnp.asarray(geom.cam_x, dtype))

    def total(cn0, offset):
        j, alpha, _, bad = coeffs(jnp.float32, offset, cn0)
        return jnp.sum(jnp.where(bad, 0.0, j) + alpha)

    for name, offset in offsets.items():
        j, alpha, keep, bad = coeffs(jnp.float32, offset, fp.cn0)
        assert np.isfinite(np.asarray(j)).all(), name
        assert np.isfinite(np.asarray(alpha)).all(), name
        g = jax.grad(total)(jnp.float32(fp.cn0), offset)
        assert np.isfinite(float(g)), name
        if name == "axis":
            assert np.asarray(bad)[np.asarray(keep)].all()
        else:
            j64, _, _, bad64 = coeffs(jnp.float64, offset, fp.cn0)
            np.testing.assert_array_equal(np.asarray(bad), np.asarray(bad64))
            np.testing.assert_allclose(np.asarray(j), np.asarray(j64),
                                       rtol=1e-4)


def test_formula_camera_gradient_finite(formula_setup):
    """Gradient wrt pixel positions (camera pose) flows through the full
    geodesic integration and stays finite."""
    cfg, geom, rays, freqs, params, fparams, mass_msun = formula_setup
    loss = make_loss(formula_setup)
    g = jax.jit(jax.grad(lambda p: loss(jnp.asarray(fparams.cn0), p)))(
        rays.positions)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0.0


def test_simulation_gradient_with_nan_fallback(tmp_path):
    """Gradient wrt the density field stays finite with fallback_nan=true
    and rays leaving the grid (the reference's NaN-poisoning semantics are
    reproduced via masks, not NaN primals)."""
    import generate_mock_simulation as gen
    from test_loaders import BASE_CONFIG
    from blacklight.pipeline_simulation import (
        load_grid, make_simulation_coeff_fns)

    # Grid covers the camera sphere (r_max > camera_r) but has an inner
    # hole (r_min = 4 > horizon): plunging rays sample off-grid -> NaN
    # pixels; grazing rays stay finite.
    p = dict(gen.DEFAULTS, r_min=4.0, r_max=60.0)
    fields = gen.make_fields(p)
    gen.write_athena(str(tmp_path / "m.athdf"), fields, p)
    cfg = parse_config(BASE_CONFIG.format(
        fmt="athena", path=str(tmp_path / "m.athdf"), coord="sks",
        out=str(tmp_path / "o.npz")))
    cfg.camera_resolution = 4
    cfg.ray_max_steps = 1200
    cfg.fallback_nan = True
    cfg.cut_omit_out = -1.0

    bh_m, bh_a, mass_msun = pipeline.bh_mass_spin(cfg)
    grid0, _ = load_grid(cfg)
    geom, rays, freqs = make_camera(cfg, bh_m=bh_m, bh_a=bh_a)
    params = pipeline.geodesic_params_from_config(cfg, bh_m, bh_a)

    def total_flux(scale):
        grid = dataclasses.replace(
            grid0, prim=grid0.prim.at[grid0.ind["rho"]].multiply(scale))
        coeff_fn, cell_fn, log_scale = make_simulation_coeff_fns(
            cfg, grid, geom, freqs, rays.momentum_factors)
        img = integrate_unpolarized(
            rays.positions, rays.directions, rays.momentum_factors, freqs,
            params=params, coeff_fn=coeff_fn, opts=ImageOptions(),
            mass_msun=mass_msun, camera_x=geom.cam_x, log_j_scale=log_scale)
        return jnp.nansum(img["I_nu"]), img["I_nu"]

    (flux, img), g = jax.jit(jax.value_and_grad(total_flux, has_aux=True))(1.0)
    # Some pixels ARE NaN (fallback semantics preserved) ...
    assert np.isnan(np.asarray(img)).any()
    # ... yet the gradient over the finite ones is finite and nonzero
    assert np.isfinite(float(g)) and float(g) != 0.0


def test_pose_gradient_dp_f32_matches_fd():
    """Camera-pose gradients through the dp integrator are finite and
    FD-correct in float32. Regression: the dp controller's
    err**(-0.2) and 1/ds_dlam carried VJP factors that overflow float32
    on parked/exact lanes (x**(-1.2), 1/x^2 at x ~ 1e-300), NaN-poisoning
    every ray's pose gradient even though the forward image was finite
    (ops/geodesic.py). rk4 was unaffected - only dp has the controller."""
    from blacklight import read_config
    from blacklight.models import formula as formula_model

    cfg = read_config(str(pathlib.Path(__file__).parent
                          / "fixtures/golden_formula_32.input"))
    cfg.camera_resolution = 4
    cfg.ray_max_steps = 600
    cfg.precision = "float32"
    bh_m, bh_a, mass_msun = pipeline.bh_mass_spin(cfg)
    geom, rays, freqs = make_camera(cfg, bh_m=bh_m, bh_a=bh_a,
                                    dtype=jnp.float32)
    params = pipeline.geodesic_params_from_config(cfg, bh_m, bh_a)
    fp = formula_model.formula_params_from_config(cfg)

    def loss(pos):
        def coeff_fn(p, k):
            j, a, _, bad = formula_model.formula_coefficients(
                p, k, rays.momentum_factors, freqs, fp, geom.cam_x)
            return j, a, bad

        img = integrate_unpolarized(
            pos, rays.directions, rays.momentum_factors, freqs,
            params=params, coeff_fn=coeff_fn,
            opts=ImageOptions(fallback_nan=False), mass_msun=mass_msun,
            camera_x=geom.cam_x,
            log_j_scale=formula_model.formula_log_j_scale(fp))
        return jnp.nansum(img["I_nu"])

    g = np.asarray(jax.jit(jax.grad(loss))(rays.positions))
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0.0

    # FD correctness in float64 (float32 central differences are pure
    # noise here: the loss's f32 resolution is ~1e-11 while the
    # directional derivative is ~1e-8, and pos + eps*e quantizes at
    # |pos| ~ 1000); reverse and forward mode must also agree.
    geom64, rays64, freqs64 = make_camera(cfg, bh_m=bh_m, bh_a=bh_a,
                                          dtype=jnp.float64)

    def loss64(pos):
        def coeff_fn(p, k):
            j, a, _, bad = formula_model.formula_coefficients(
                p, k, rays64.momentum_factors, freqs64, fp, geom64.cam_x)
            return j, a, bad

        img = integrate_unpolarized(
            pos, rays64.directions, rays64.momentum_factors, freqs64,
            params=params, coeff_fn=coeff_fn,
            opts=ImageOptions(fallback_nan=False), mass_msun=mass_msun,
            camera_x=geom64.cam_x,
            log_j_scale=formula_model.formula_log_j_scale(fp))
        return jnp.nansum(img["I_nu"])

    e = jnp.asarray(np.broadcast_to(
        np.array([0.0, 0.3, -0.2, 0.1]), rays64.positions.shape))
    g64 = jax.jit(jax.grad(loss64))(rays64.positions)
    gd = float(jnp.sum(g64 * e))
    _, jv = jax.jit(lambda p, t: jax.jvp(loss64, (p,), (t,)))(
        rays64.positions, e)
    np.testing.assert_allclose(gd, float(jv), rtol=1e-8)

    f = jax.jit(lambda d: loss64(rays64.positions + d * e))
    eps = 1e-4
    fd = (float(f(jnp.float64(eps))) - float(f(jnp.float64(-eps)))) \
        / (2 * eps)
    np.testing.assert_allclose(gd, fd, rtol=1e-4)


def test_simulation_prim_gradient_finite_f32(tmp_path):
    """d flux / d EVERY grid cell is finite in float32, including floor-
    density cells (rho ~ 1e-8). Regression: kb_tt_tot_cgs used to divide
    by rho_cgs (~1e-25), whose VJP intermediate 1/rho_cgs^2 overflows
    float32 to inf, poisoning the whole-field gradient even when every
    pixel is finite (synchrotron.py fluid_state)."""
    import generate_mock_simulation as gen
    from test_loaders import BASE_CONFIG
    from blacklight.pipeline_simulation import (
        load_grid, make_simulation_coeff_fns)

    fields = gen.make_fields(gen.DEFAULTS)
    gen.write_athena(str(tmp_path / "m.athdf"), fields, gen.DEFAULTS)
    cfg = parse_config(BASE_CONFIG.format(
        fmt="athena", path=str(tmp_path / "m.athdf"), coord="sks",
        out=str(tmp_path / "o.npz")))
    cfg.camera_resolution = 8
    cfg.ray_max_steps = 300
    cfg.precision = "float32"

    bh_m, bh_a, mass_msun = pipeline.bh_mass_spin(cfg)
    grid0, _ = load_grid(cfg)
    geom, rays, freqs = make_camera(cfg, bh_m=bh_m, bh_a=bh_a,
                                    dtype=jnp.float32)
    params = pipeline.geodesic_params_from_config(cfg, bh_m, bh_a)

    def total_flux(prim):
        grid = dataclasses.replace(grid0, prim=prim)
        coeff_fn, cell_fn, log_scale = make_simulation_coeff_fns(
            cfg, grid, geom, freqs, rays.momentum_factors)
        img = integrate_unpolarized(
            rays.positions, rays.directions, rays.momentum_factors, freqs,
            params=params, coeff_fn=coeff_fn,
            opts=ImageOptions(fallback_nan=False), mass_msun=mass_msun,
            camera_x=geom.cam_x, log_j_scale=log_scale)
        return jnp.nansum(img["I_nu"])

    g = np.asarray(jax.jit(jax.grad(total_flux))(grid0.prim))
    assert np.isfinite(g).all()
    assert (g != 0).any()


def test_polarized_gradient_matches_fd(fixtures_dir):
    """AD gradient of total Stokes-I flux wrt a density scale through the
    FULL polarized path (coherency transport + tetrad coupling + Faraday
    rotation + admissibility clamps) matches central finite differences.
    The scan body is jax.checkpoint'ed, so backward rematerializes each
    step instead of storing every per-step intermediate."""
    from blacklight import read_config
    from blacklight.pipeline_simulation import (
        load_grid, make_simulation_coeff_fns)
    from blacklight.transfer.polarized import integrate_polarized

    cfg = read_config(str(fixtures_dir / "golden_polarized_rk4_32.input"))
    cfg.simulation_file = str(fixtures_dir / "mock_small.athdf")
    cfg.camera_resolution = 2
    cfg.ray_max_steps = 2000

    bh_m, bh_a, mass_msun = pipeline.bh_mass_spin(cfg)
    grid0, _ = load_grid(cfg)
    geom, rays, freqs = make_camera(cfg, bh_m=bh_m, bh_a=bh_a)
    params = pipeline.geodesic_params_from_config(cfg, bh_m, bh_a)

    def stokes(scale):
        grid = dataclasses.replace(
            grid0, prim=grid0.prim.at[grid0.ind["rho"]].multiply(scale))
        coeff_fn, cell_fn, log_scale = make_simulation_coeff_fns(
            cfg, grid, geom, freqs, rays.momentum_factors, polarized=True)
        img = integrate_polarized(
            rays.positions, rays.directions, rays.momentum_factors, freqs,
            params=params, coeff_fn=coeff_fn, opts=ImageOptions(),
            mass_msun=mass_msun, camera_x=geom.cam_x,
            camera_u_con=geom.u_con, camera_u_cov=geom.u_cov,
            camera_vert_con_c=geom.vert_con_c, log_j_scale=log_scale)
        return (jnp.nansum(img["I_nu"]) + jnp.nansum(jnp.abs(img["Q_nu"]))
                + jnp.nansum(jnp.abs(img["V_nu"])))

    f = jax.jit(stokes)
    g = jax.jit(jax.grad(stokes))(jnp.asarray(1.0))
    eps = 1e-4
    fd = (f(jnp.asarray(1.0 + eps)) - f(jnp.asarray(1.0 - eps))) / (2 * eps)
    assert np.isfinite(float(g))
    np.testing.assert_allclose(float(g), float(fd), rtol=2e-3)


def test_polarized_gradient_rotation_split_finite(fixtures_dir):
    """The Strang-rotation-split coupling mode also has finite, nonzero
    gradients (clamp ladders are where()-sanitized)."""
    from blacklight import read_config
    from blacklight.pipeline_simulation import (
        load_grid, make_simulation_coeff_fns)
    from blacklight.transfer.polarized import integrate_polarized

    cfg = read_config(str(fixtures_dir / "golden_polarized_rk4_32.input"))
    cfg.simulation_file = str(fixtures_dir / "mock_small.athdf")
    cfg.camera_resolution = 2
    cfg.ray_max_steps = 2000

    bh_m, bh_a, mass_msun = pipeline.bh_mass_spin(cfg)
    grid0, _ = load_grid(cfg)
    geom, rays, freqs = make_camera(cfg, bh_m=bh_m, bh_a=bh_a)
    params = pipeline.geodesic_params_from_config(cfg, bh_m, bh_a)

    def total(scale):
        grid = dataclasses.replace(
            grid0, prim=grid0.prim.at[grid0.ind["rho"]].multiply(scale))
        coeff_fn, cell_fn, log_scale = make_simulation_coeff_fns(
            cfg, grid, geom, freqs, rays.momentum_factors, polarized=True)
        img = integrate_polarized(
            rays.positions, rays.directions, rays.momentum_factors, freqs,
            params=params, coeff_fn=coeff_fn, opts=ImageOptions(),
            mass_msun=mass_msun, camera_x=geom.cam_x,
            camera_u_con=geom.u_con, camera_u_cov=geom.u_cov,
            camera_vert_con_c=geom.vert_con_c, log_j_scale=log_scale,
            rotation_split=True)
        return jnp.nansum(img["I_nu"])

    g = jax.jit(jax.grad(total))(jnp.asarray(1.0))
    assert np.isfinite(float(g)) and float(g) != 0.0
