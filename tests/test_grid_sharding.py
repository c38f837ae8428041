"""Spatially sharded grid: sharded render must match replicated exactly."""

import numpy as np
import pytest

import jax

from blacklight import read_config, pipeline
from blacklight.camera import make_camera
from blacklight.grid.athena import with_packed_corners
from blacklight.parallel.grid_sharding import (
    make_grid_mesh, make_sharded_renderer, split_prim_cells)
from blacklight.pipeline_simulation import (
    _sampler_options, load_grid, make_simulation_coeff_fns)
from blacklight.transfer.unpolarized import ImageOptions, integrate_unpolarized


@pytest.fixture(scope="module")
def setup(fixtures_dir):
    cfg = read_config(str(fixtures_dir / "golden_sim_rk4_32.input"))
    cfg.simulation_file = str(fixtures_dir / "mock_small.athdf")
    cfg.camera_resolution = 8
    cfg.ray_max_steps = 1200
    bh_m, bh_a, mass_msun = pipeline.bh_mass_spin(cfg)
    grid, _ = load_grid(cfg)
    grid = with_packed_corners(grid)
    geom, rays, freqs = make_camera(cfg, bh_m=bh_m, bh_a=bh_a)
    params = pipeline.geodesic_params_from_config(cfg, bh_m, bh_a)
    return cfg, grid, geom, rays, freqs, params, mass_msun


def _replicated_image(setup):
    cfg, grid, geom, rays, freqs, params, mass_msun = setup
    coeff_fn, cell_fn, log_scale = make_simulation_coeff_fns(
        cfg, grid, geom, freqs, rays.momentum_factors)
    img = jax.jit(lambda p, d, m: integrate_unpolarized(
        p, d, m, freqs, params=params, coeff_fn=coeff_fn,
        opts=ImageOptions.from_config(cfg), mass_msun=mass_msun,
        camera_x=geom.cam_x, log_j_scale=log_scale, early_exit=False))(
            rays.positions, rays.directions, rays.momentum_factors)
    return jax.tree.map(np.asarray, img)


@pytest.mark.parametrize("ray_shards,grid_shards", [(2, 4), (1, 8)])
def test_sharded_grid_bit_matches_replicated(setup, ray_shards, grid_shards):
    """A (rays x grid) mesh with the snapshot's phi planes split across the
    'grid' axis renders the identical image: every corner gather is owned
    by exactly one shard and psum adds structural zeros, so the sampled
    values match the replicated path exactly; the only tolerated
    difference is last-ulp compiler re-association in the downstream
    accumulation (measured <= 1 ulp on a few pixels)."""
    cfg, grid, geom, rays, freqs, params, mass_msun = setup
    if len(jax.devices()) < ray_shards * grid_shards:
        pytest.skip("needs 8 virtual devices")
    mesh = make_grid_mesh(ray_shards, grid_shards)
    render = make_sharded_renderer(
        cfg, grid, geom, freqs, mesh, mass_msun, params,
        ImageOptions.from_config(cfg))
    img_sharded = render(rays.positions, rays.directions,
                         rays.momentum_factors)
    img_repl = _replicated_image(setup)
    for key in ("_flags", "_n_samples"):
        np.testing.assert_array_equal(img_sharded[key], img_repl[key],
                                      err_msg=key)
    a = img_sharded["I_nu"]
    b = img_repl["I_nu"]
    assert np.array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)],
                               rtol=1e-14, err_msg="I_nu")


def test_split_prim_cells_roundtrip(setup):
    """Slab split partitions the primitive table without loss."""
    cfg, grid, geom, rays, freqs, params, mass_msun = setup
    slabbed, k_per = split_prim_cells(grid, 4)
    nvar, n_b, n_k, n_j, n_i = grid.prim.shape
    assert k_per == n_k // 4
    re = np.moveaxis(
        np.asarray(slabbed).reshape(4, nvar, n_b, k_per, n_j, n_i), 0, 2
    ).reshape(nvar, n_b, n_k, n_j, n_i)
    np.testing.assert_array_equal(re, np.asarray(grid.prim))
