"""Forward+backward throughput for the simulation and polarized paths.

BASELINE.md's north-star metric is "rays/s/chip forward and
forward+backward" per path. bench_gradient.py covers the formula model;
this script measures the two paths where backward is most expensive:

  --path simulation: unpolarized thermal synchrotron RT on a mock GRMHD
    grid, differentiating total flux with respect to the FULL primitive
    array (d flux / d every grid cell - the inverse-GRMHD capability; the
    reference has no equivalent at any speed).
  --path polarized: full-Stokes IQUV transport, same d/d grid gradient.

The grid is NOT corner-packed here: reverse-mode flows through plain
prim gathers (the packed table is a forward-only layout; its cotangent
would be an 8x scatter). The scan bodies are jax.checkpoint'ed, so
backward rematerializes each step's samples instead of storing them.

    python scripts/bench_gradient_sim.py --path simulation [--res 256]
"""

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=["simulation", "polarized"],
                    default="simulation")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--grid", default="128,64,64")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    n_r, n_th, n_ph = (int(s) for s in args.grid.split(","))
    mock = f"/tmp/bench_mock_{n_r}x{n_th}x{n_ph}.athdf"
    root = pathlib.Path(__file__).resolve().parents[1]
    if not pathlib.Path(mock).exists():
        subprocess.run(
            [sys.executable, str(root / "scripts/generate_mock_simulation.py"),
             mock, "--n_r", str(n_r), "--n_th", str(n_th),
             "--n_ph", str(n_ph), "--r_min", "1.916", "--r_max", "52.2",
             "--pert_amp", "0.1"], check=True)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from blacklight import pipeline, read_config
    from blacklight.camera import make_camera
    from blacklight.pipeline_simulation import (
        load_grid, make_simulation_coeff_fns)
    from blacklight.transfer.unpolarized import (
        ImageOptions, integrate_unpolarized)

    fixtures = root / "tests/fixtures"
    polarized = args.path == "polarized"
    cfg = read_config(str(fixtures / ("golden_polarized_rk4_32.input"
                                      if polarized
                                      else "golden_sim_rk4_32.input")))
    cfg.simulation_file = mock
    cfg.precision = "float32"
    cfg.ray_max_steps = args.steps
    cfg.camera_resolution = args.res

    bh_m, bh_a, mass_msun = pipeline.bh_mass_spin(cfg)
    grid0, _ = load_grid(cfg)
    geom, rays, freqs = make_camera(cfg, bh_m=bh_m, bh_a=bh_a,
                                    dtype=jnp.float32)
    params = pipeline.geodesic_params_from_config(cfg, bh_m, bh_a)
    opts = ImageOptions(fallback_nan=False)

    if polarized:
        from blacklight.transfer.polarized import integrate_polarized

        def loss(prim, pos, dirs, moms):
            grid = dataclasses.replace(grid0, prim=prim)
            coeff_fn, cell_fn, log_scale = make_simulation_coeff_fns(
                cfg, grid, geom, freqs, moms, polarized=True)
            img = integrate_polarized(
                pos, dirs, moms, freqs, params=params, coeff_fn=coeff_fn,
                opts=opts, mass_msun=mass_msun, camera_x=geom.cam_x,
                camera_u_con=geom.u_con, camera_u_cov=geom.u_cov,
                camera_vert_con_c=geom.vert_con_c, log_j_scale=log_scale)
            return jnp.nansum(img["I_nu"]) + jnp.nansum(img["Q_nu"]) \
                + jnp.nansum(img["U_nu"]) + jnp.nansum(img["V_nu"])
    else:
        def loss(prim, pos, dirs, moms):
            grid = dataclasses.replace(grid0, prim=prim)
            coeff_fn, cell_fn, log_scale = make_simulation_coeff_fns(
                cfg, grid, geom, freqs, moms)
            img = integrate_unpolarized(
                pos, dirs, moms, freqs, params=params, coeff_fn=coeff_fn,
                opts=opts, mass_msun=mass_msun, camera_x=geom.cam_x,
                log_j_scale=log_scale)
            return jnp.nansum(img["I_nu"])

    grad_fn = jax.jit(jax.value_and_grad(loss))

    res, tile = args.res, args.tile
    n = res * res
    idx = np.arange(n).reshape(res, res)
    order = idx.reshape(res // tile, tile, res // tile,
                        tile).transpose(0, 2, 1, 3).reshape(-1)
    P = jnp.asarray(np.asarray(rays.positions)[order])
    D = jnp.asarray(np.asarray(rays.directions)[order])
    M = jnp.asarray(np.asarray(rays.momentum_factors)[order])
    chunk = tile * tile
    prim = grid0.prim

    def run_all():
        flux = 0.0
        g_acc = None
        for i in range(0, n, chunk):
            v, g = grad_fn(prim, P[i:i + chunk], D[i:i + chunk],
                           M[i:i + chunk])
            flux = flux + v
            g_acc = g if g_acc is None else g_acc + g
        jax.block_until_ready(g_acc)
        return flux, g_acc

    t0 = time.perf_counter()
    flux, g = run_all()
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        flux, g = run_all()
        times.append(time.perf_counter() - t0)
    t = min(times)
    g = np.asarray(g)
    assert np.isfinite(float(flux))
    assert np.isfinite(g).all() and np.abs(g).max() > 0.0
    print(json.dumps({
        "path": args.path, "res": res, "steps": args.steps,
        "grid": args.grid, "mode": "forward+backward", "wrt": "grid prims",
        "grad_nonzero_cells": int((g != 0).sum()),
        "time_s": round(t, 2), "compile_s": round(compile_s, 1),
        "rays_per_s": round(n / t, 1),
    }))


if __name__ == "__main__":
    main()
