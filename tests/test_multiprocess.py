"""Multi-host simulation on one host: two jax processes over localhost.

Exercises parallel/distributed.py for real (SURVEY 4 / 5.8): the workers
handshake via jax.distributed, build the pod mesh, render their pixel
shards of a formula image, and reduce a global-flux gradient across
processes. The test asserts both processes agree and match a
single-process computation.
"""

import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("nproc", [2])
def test_two_process_render_and_gradient(tmp_path, nproc):
    worker = pathlib.Path(__file__).parent / "helpers_multiprocess_worker.py"
    port = _free_port()
    procs = []
    outs = []
    for pid in range(nproc):
        out = tmp_path / f"proc{pid}.npz"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(port), str(pid), str(nproc),
             str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    for p in procs:
        stdout, _ = p.communicate(timeout=900)
        logs.append(stdout.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]

    results = [np.load(o) for o in outs]
    for r in results:
        assert int(r["process_count"]) == nproc
    # Every process sees the same global flux, gradient, and image
    for r in results[1:]:
        np.testing.assert_allclose(r["flux"], results[0]["flux"], rtol=1e-12)
        np.testing.assert_allclose(r["grad"], results[0]["grad"], rtol=1e-12)
        np.testing.assert_allclose(r["image"], results[0]["image"],
                                   rtol=1e-12)

    # ... and they match a single-process computation of the same thing
    import dataclasses

    import jax
    import jax.numpy as jnp

    from blacklight import pipeline, read_config
    from blacklight.camera import make_camera
    from blacklight.models import formula as formula_model
    from blacklight.transfer.unpolarized import (ImageOptions,
                                                     integrate_unpolarized)

    fixtures = pathlib.Path(__file__).parent / "fixtures"
    cfg = read_config(str(fixtures / "golden_formula_32.input"))
    cfg.camera_resolution = 8
    cfg.ray_max_steps = 600
    bh_m, bh_a, mass_msun = pipeline.bh_mass_spin(cfg)
    geom, rays, freqs = make_camera(cfg, bh_m=bh_m, bh_a=bh_a)
    params = pipeline.geodesic_params_from_config(cfg, bh_m, bh_a)
    fparams = formula_model.formula_params_from_config(cfg)

    def total_flux(cn0):
        fp = dataclasses.replace(fparams, cn0=cn0)

        def coeff_fn(p, k):
            j, alpha, _, bad = formula_model.formula_coefficients(
                p, k, rays.momentum_factors, freqs, fp, geom.cam_x)
            return j, alpha, bad

        img = integrate_unpolarized(
            rays.positions, rays.directions, rays.momentum_factors, freqs,
            params=params, coeff_fn=coeff_fn,
            opts=ImageOptions(fallback_nan=False), mass_msun=mass_msun,
            camera_x=geom.cam_x, early_exit=False,
            log_j_scale=formula_model.formula_log_j_scale(fp))
        return jnp.sum(img["I_nu"]), img["I_nu"]

    (flux, img), grad = jax.jit(
        jax.value_and_grad(total_flux, has_aux=True))(
            jnp.asarray(fparams.cn0))
    np.testing.assert_allclose(results[0]["flux"], float(flux), rtol=1e-10)
    np.testing.assert_allclose(results[0]["grad"], float(grad), rtol=1e-10)
    np.testing.assert_allclose(results[0]["image"], np.asarray(img),
                               rtol=1e-10)


def test_two_process_sharded_grid(tmp_path):
    """The ('rays', 'grid') mesh with the GRID axis spanning two processes:
    each process holds half of every phi(k) slab, the sampler's corner
    psums cross the process boundary, and the all-gathered image matches a
    single-process replicated render."""
    worker = (pathlib.Path(__file__).parent
              / "helpers_multiprocess_grid_worker.py")
    port = _free_port()
    nproc = 2
    procs, outs = [], []
    for pid in range(nproc):
        out = tmp_path / f"gproc{pid}.npz"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(port), str(pid), str(nproc),
             str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    for p in procs:
        stdout, _ = p.communicate(timeout=900)
        logs.append(stdout.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]

    results = [np.load(o) for o in outs]
    for r in results:
        assert int(r["process_count"]) == nproc
    np.testing.assert_allclose(results[1]["I_nu"], results[0]["I_nu"],
                               rtol=1e-12)

    # Single-process replicated reference
    import jax

    from blacklight import pipeline, read_config
    from blacklight.camera import make_camera
    from blacklight.pipeline_simulation import (
        load_grid, make_simulation_coeff_fns)
    from blacklight.transfer.unpolarized import (ImageOptions,
                                                     integrate_unpolarized)

    fixtures = pathlib.Path(__file__).parent / "fixtures"
    cfg = read_config(str(fixtures / "golden_sim_rk4_32.input"))
    cfg.simulation_file = str(fixtures / "mock_small.athdf")
    cfg.camera_resolution = 8
    cfg.ray_max_steps = 600
    bh_m, bh_a, mass_msun = pipeline.bh_mass_spin(cfg)
    grid, snapshot_time = load_grid(cfg)
    geom, rays, freqs = make_camera(cfg, bh_m=bh_m, bh_a=bh_a)
    params = pipeline.geodesic_params_from_config(cfg, bh_m, bh_a)
    coeff_fn, cell_fn, log_scale = make_simulation_coeff_fns(
        cfg, grid, geom, freqs, rays.momentum_factors,
        snapshot_time=snapshot_time)
    img = jax.jit(lambda p, d, m: integrate_unpolarized(
        p, d, m, freqs, params=params, coeff_fn=coeff_fn,
        opts=ImageOptions.from_config(cfg), mass_msun=mass_msun,
        camera_x=geom.cam_x, log_j_scale=log_scale, early_exit=False))(
            rays.positions, rays.directions, rays.momentum_factors)
    a, b = results[0]["I_nu"], np.asarray(img["I_nu"])
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)], rtol=1e-11)
