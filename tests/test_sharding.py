"""Multi-device sharding tests on the 8-device virtual CPU mesh.

The reference's only parallelism is OpenMP over pixels; here pixels shard
over a jax.sharding.Mesh and results must be bit-identical to the
single-device computation (rays are independent; no cross-device math).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from blacklight import pipeline
from blacklight.camera import make_camera
from blacklight.models import formula as formula_model
from blacklight.parallel.sharding import make_mesh, shard_rays, unshard
from blacklight.transfer.unpolarized import ImageOptions, integrate_unpolarized
from blacklight.utils.config import parse_config

from test_adaptive import CONFIG


def make_cfg(tmp_path, res=16):
    return parse_config(CONFIG.format(out=str(tmp_path / "out.npz"), res=res,
                                      max_level=0, num_regions=0, regions=""))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = make_cfg(tmp_path_factory.mktemp("shard"), res=16)
    bh_m, bh_a, mass_msun = pipeline.bh_mass_spin(cfg)
    geom, rays, freqs = make_camera(cfg, bh_m=bh_m, bh_a=bh_a)
    params = pipeline.geodesic_params_from_config(cfg, bh_m, bh_a)
    fparams = formula_model.formula_params_from_config(cfg)

    def render(positions, directions, momentum_factors, cn0=None):
        fp = fparams if cn0 is None else __import__("dataclasses").replace(
            fparams, cn0=cn0)

        def coeff_fn(pos, kcov):
            j, alpha, _, bad = formula_model.formula_coefficients(
                pos, kcov, momentum_factors, freqs, fp, geom.cam_x)
            return j, alpha, bad

        img = integrate_unpolarized(
            positions, directions, momentum_factors, freqs,
            params=params, coeff_fn=coeff_fn,
            opts=ImageOptions(fallback_nan=False),
            mass_msun=mass_msun, camera_x=geom.cam_x,
            log_j_scale=formula_model.formula_log_j_scale(fp))
        return img["I_nu"]

    return cfg, rays, render, fparams


def test_sharded_render_matches_single_device(setup):
    cfg, rays, render, fparams = setup
    base = np.asarray(jax.jit(render)(
        rays.positions, rays.directions, rays.momentum_factors))

    mesh = make_mesh(jax.devices()[:8])
    pos, dirs, mom, orig_n = shard_rays(
        rays.positions, rays.directions, rays.momentum_factors, mesh)
    pixel = NamedSharding(mesh, P("pixels"))
    out = jax.jit(render, in_shardings=(pixel, pixel, pixel),
                  out_shardings=pixel)(pos, dirs, mom)
    out = unshard(out, orig_n)
    # SPMD partitioning may reassociate fusions: allow ulp-level slack
    np.testing.assert_allclose(np.asarray(out), base, rtol=1e-12)


def test_sharded_gradient_matches_single_device(setup):
    """d(total flux)/d(cn0) psum-reduced over the mesh equals the
    single-device gradient."""
    cfg, rays, render, fparams = setup

    def loss(cn0, p, d, m):
        return jnp.sum(render(p, d, m, cn0=cn0))

    g_base = jax.jit(jax.grad(loss))(
        jnp.asarray(fparams.cn0), rays.positions, rays.directions,
        rays.momentum_factors)

    mesh = make_mesh(jax.devices()[:8])
    pos, dirs, mom, _ = shard_rays(
        rays.positions, rays.directions, rays.momentum_factors, mesh)
    pixel = NamedSharding(mesh, P("pixels"))
    rep = NamedSharding(mesh, P())
    # Padding duplicates rays 0..pad-1; subtract their extra contribution by
    # comparing against the base gradient of the padded bundle instead
    g_base_padded = jax.jit(jax.grad(loss))(
        jnp.asarray(fparams.cn0), np.asarray(pos), np.asarray(dirs),
        np.asarray(mom))
    g_shard = jax.jit(jax.grad(loss),
                      in_shardings=(rep, pixel, pixel, pixel),
                      out_shardings=rep)(
        jax.device_put(jnp.asarray(fparams.cn0), rep), pos, dirs, mom)
    np.testing.assert_allclose(np.asarray(g_shard), np.asarray(g_base_padded),
                               rtol=1e-12)
    assert np.isfinite(g_base)


def test_graft_dryrun_multichip():
    """The driver's multichip dry run executes on the 8-device CPU mesh."""
    import importlib.util
    import pathlib
    spec = importlib.util.spec_from_file_location(
        "graft_entry", pathlib.Path(__file__).parent.parent / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)
