"""Worker for the multi-process (multi-host simulation) test.

Launched as: python helpers_multiprocess_worker.py <port> <pid> <nproc> <out>

Each process owns 2 virtual CPU devices; jax.distributed.initialize over
localhost forms a 2-process "pod" (SURVEY 4: multi-host tests via JAX
multi-process simulation on a single host). The worker renders its pixel
shard of a small formula image through the distributed mesh and computes
the gradient of the GLOBAL flux wrt the emission amplitude - the psum
rides the same cross-process collectives a real pod would use - then
writes its results for the driving test to compare.
"""

import os
import pathlib
import sys


def main():
    port, pid, nproc, out = sys.argv[1:5]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["JAX_ENABLE_X64"] = "1"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    repo = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(repo))

    from blacklight.parallel import distributed

    distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=int(nproc), process_id=int(pid))
    assert jax.process_count() == int(nproc), jax.process_count()
    assert len(jax.devices()) == 2 * int(nproc)

    import dataclasses

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from blacklight import pipeline, read_config
    from blacklight.camera import make_camera
    from blacklight.models import formula as formula_model
    from blacklight.transfer.unpolarized import (ImageOptions,
                                                     integrate_unpolarized)

    cfg = read_config(str(repo / "tests/fixtures/golden_formula_32.input"))
    cfg.camera_resolution = 8
    cfg.ray_max_steps = 600
    bh_m, bh_a, mass_msun = pipeline.bh_mass_spin(cfg)
    geom, rays, freqs = make_camera(cfg, bh_m=bh_m, bh_a=bh_a)
    params = pipeline.geodesic_params_from_config(cfg, bh_m, bh_a)
    fparams = formula_model.formula_params_from_config(cfg)

    mesh = distributed.pod_mesh()
    sharding = NamedSharding(mesh, P("pixels"))
    n = rays.positions.shape[0]
    sl = distributed.local_slice(n)

    def globalize(a):
        return jax.make_array_from_process_local_data(
            sharding if a.ndim == 1 else NamedSharding(mesh, P("pixels", None)),
            np.asarray(a)[sl])

    pos = globalize(rays.positions)
    dirs = globalize(rays.directions)
    moms = globalize(rays.momentum_factors)

    def total_flux(cn0, pos, dirs, moms):
        fp = dataclasses.replace(fparams, cn0=cn0)

        def coeff_fn(p, k):
            j, alpha, _, bad = formula_model.formula_coefficients(
                p, k, moms, freqs, fp, geom.cam_x)
            return j, alpha, bad

        img = integrate_unpolarized(
            pos, dirs, moms, freqs, params=params, coeff_fn=coeff_fn,
            opts=ImageOptions(fallback_nan=False), mass_msun=mass_msun,
            camera_x=geom.cam_x, early_exit=False,
            log_j_scale=formula_model.formula_log_j_scale(fp))
        return jnp.sum(img["I_nu"]), img["I_nu"]

    (flux, img), grad = jax.jit(
        jax.value_and_grad(total_flux, has_aux=True))(
            jnp.asarray(fparams.cn0), pos, dirs, moms)

    from jax.experimental import multihost_utils
    img_full = multihost_utils.process_allgather(img, tiled=True)
    np.savez(out, flux=np.asarray(flux), grad=np.asarray(grad),
             image=np.asarray(img_full),
             process_count=jax.process_count())


if __name__ == "__main__":
    main()
