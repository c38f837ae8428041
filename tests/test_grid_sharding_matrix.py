"""Sharded-grid feature matrix: polarized / slow-light / interblock-AMR
renders under the ('rays', 'grid') mesh must match their replicated
counterparts.

The corner psum trick (parallel/grid_sharding.py) is renderer-agnostic:
sampling is the only grid-touching op, exactly one shard owns each fetched
cell, and the psum of one owned value plus structural zeros reproduces the
replicated gather bit-for-bit. These tests pin that property for every
sampler mode the reference supports (simulation_sampling.cpp:636-1044):
full-Stokes IQUV, slow-light temporal interpolation (:297-349, 923-1044),
and exact cross-level interblock interpolation (:1068-1386).
"""

import pathlib
import sys

import numpy as np
import pytest

import jax

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "scripts"))
sys.path.insert(0, str(pathlib.Path(__file__).parent))

from blacklight import read_config, pipeline
from blacklight.camera import make_camera
from blacklight.parallel.grid_sharding import (
    make_grid_mesh, make_sharded_renderer)
from blacklight.pipeline_simulation import (
    load_grid, make_simulation_coeff_fns)
from blacklight.transfer.unpolarized import (
    ImageOptions, integrate_unpolarized)


def _assert_image_match(img_sharded, img_repl, rtol=1e-11):
    # The sampled corner values are IDENTICAL (one owner + structural
    # zeros); the tolerance only absorbs downstream re-association noise
    # from different XLA fusion under shard_map (measured <= 3e-13 rel on
    # the polarized path's matrix-exponential chains). A real ownership
    # bug produces O(1) errors.
    for key in sorted(set(img_repl) & set(img_sharded)):
        a, b = np.asarray(img_sharded[key]), np.asarray(img_repl[key])
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=key)
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                      err_msg=key + " nan pattern")
        np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)],
                                   rtol=rtol, atol=0, err_msg=key)


def _setup(cfg):
    bh_m, bh_a, mass_msun = pipeline.bh_mass_spin(cfg)
    grid, snapshot_time = load_grid(cfg)
    geom, rays, freqs = make_camera(cfg, bh_m=bh_m, bh_a=bh_a)
    params = pipeline.geodesic_params_from_config(cfg, bh_m, bh_a)
    return grid, snapshot_time, geom, rays, freqs, params, mass_msun


def _replicated(cfg, grid, geom, rays, freqs, params, mass_msun,
                snapshot_time=0.0, polarized=False):
    coeff_fn, cell_fn, log_scale = make_simulation_coeff_fns(
        cfg, grid, geom, freqs, rays.momentum_factors,
        polarized=polarized, snapshot_time=snapshot_time)
    opts = ImageOptions.from_config(cfg)
    if polarized:
        from blacklight.transfer.polarized import integrate_polarized
        img = jax.jit(lambda p, d, m: integrate_polarized(
            p, d, m, freqs, params=params, coeff_fn=coeff_fn, opts=opts,
            mass_msun=mass_msun, camera_x=geom.cam_x,
            camera_u_con=geom.u_con, camera_u_cov=geom.u_cov,
            camera_vert_con_c=geom.vert_con_c, log_j_scale=log_scale,
            rotation_split=bool(cfg.require("image_rotation_split"))))(
                rays.positions, rays.directions, rays.momentum_factors)
    else:
        img = jax.jit(lambda p, d, m: integrate_unpolarized(
            p, d, m, freqs, params=params, coeff_fn=coeff_fn, opts=opts,
            mass_msun=mass_msun, camera_x=geom.cam_x, log_j_scale=log_scale,
            early_exit=False))(
                rays.positions, rays.directions, rays.momentum_factors)
    return jax.tree.map(np.asarray, img)


def _run_matrix_case(cfg, ray_shards, grid_shards, polarized=False):
    if len(jax.devices()) < ray_shards * grid_shards:
        pytest.skip("needs 8 virtual devices")
    grid, snapshot_time, geom, rays, freqs, params, mass_msun = _setup(cfg)
    mesh = make_grid_mesh(ray_shards, grid_shards)
    render = make_sharded_renderer(
        cfg, grid, geom, freqs, mesh, mass_msun, params,
        ImageOptions.from_config(cfg), snapshot_time=snapshot_time,
        polarized=polarized)
    img_sharded = render(rays.positions, rays.directions,
                         rays.momentum_factors)
    img_repl = _replicated(cfg, grid, geom, rays, freqs, params, mass_msun,
                           snapshot_time=snapshot_time, polarized=polarized)
    _assert_image_match(img_sharded, img_repl)
    assert np.isfinite(
        np.asarray(img_sharded["I_nu"], dtype=np.float64)).any()


@pytest.mark.parametrize("ray_shards,grid_shards", [(2, 4), (1, 8)])
def test_sharded_polarized_matches_replicated(fixtures_dir, ray_shards,
                                              grid_shards):
    """Full-Stokes IQUV under the sharded grid == replicated."""
    cfg = read_config(str(fixtures_dir / "golden_plasma_mix_pol_rk4_32.input"))
    cfg.simulation_file = str(fixtures_dir / "mock_small.athdf")
    cfg.camera_resolution = 8
    cfg.ray_max_steps = 600
    _run_matrix_case(cfg, ray_shards, grid_shards, polarized=True)


def test_sharded_amr_block_interp_matches_replicated(fixtures_dir):
    """Exact cross-level interblock interpolation under the sharded grid:
    the AMR neighbor table stays replicated; only the primitive slab is
    split, and every cross-block corner fetch psums to its owner's value."""
    cfg = read_config(str(fixtures_dir / "golden_amr_rk4_32.input"))
    cfg.simulation_file = str(fixtures_dir / "mock_amr.athdf")
    cfg.camera_resolution = 8
    cfg.ray_max_steps = 600
    assert bool(cfg.simulation_block_interp)
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    grid, snapshot_time, geom, rays, freqs, params, mass_msun = _setup(cfg)
    from blacklight.grid.amr import with_amr_table
    grid = with_amr_table(grid)
    mesh = make_grid_mesh(2, 4)     # mock_amr has n_k=4 planes per block
    render = make_sharded_renderer(
        cfg, grid, geom, freqs, mesh, mass_msun, params,
        ImageOptions.from_config(cfg), snapshot_time=snapshot_time)
    img_sharded = render(rays.positions, rays.directions,
                         rays.momentum_factors)
    img_repl = _replicated(cfg, grid, geom, rays, freqs, params, mass_msun,
                           snapshot_time=snapshot_time)
    _assert_image_match(img_sharded, img_repl)
    assert np.isfinite(np.asarray(img_sharded["I_nu"],
                                  dtype=np.float64)).any()


def test_sharded_slow_light_matches_replicated(fixtures_dir):
    """Slow-light window slabs (leading time axis) under the sharded grid:
    per-slice spatial fetch + psum, then the temporal lerp on psummed
    results == replicated."""
    cfg = read_config(str(fixtures_dir / "slowlight" / "golden_slow.input"))
    cfg.simulation_file = str(
        fixtures_dir / "slowlight" / "small.{5d}.athdf")
    cfg.camera_resolution = 8
    cfg.ray_max_steps = 600
    assert bool(cfg.slow_light_on)
    _run_matrix_case(cfg, 2, 4, polarized=False)
