"""Forward+backward (pixel-gradient) throughput benchmark.

BASELINE.md north-star includes "rays/s/chip forward and forward+backward":
this renders the formula-model image AND differentiates the total flux
with respect to the emission amplitude and the per-pixel ray positions
(camera pose) through the full geodesic + RT computation - capability the
reference does not have at any speed.

    python scripts/bench_gradient.py [--res 512] [--steps 2000]
"""

import argparse
import dataclasses
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--precision", default="float32")
    ap.add_argument("--pose", action="store_true",
                    help="also differentiate wrt ray positions (camera "
                         "pose) through the full geodesic integration; "
                         "works at float32 (the dp controller's pow/div "
                         "VJPs are float32-sanitized, ops/geodesic.py)")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.precision == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from blacklight import pipeline, read_config
    from blacklight.camera import make_camera
    from blacklight.models import formula as formula_model
    from blacklight.transfer.unpolarized import (ImageOptions,
                                                 integrate_unpolarized)

    root = pathlib.Path(__file__).resolve().parents[1]
    cfg = read_config(str(root / "tests/fixtures/golden_formula_32.input"))
    cfg.camera_resolution = args.res
    cfg.ray_max_steps = args.steps
    cfg.precision = args.precision
    bh_m, bh_a, mass_msun = pipeline.bh_mass_spin(cfg)
    geom, rays, freqs = make_camera(cfg, bh_m=bh_m, bh_a=bh_a,
                                    dtype=jnp.float32
                                    if args.precision == "float32"
                                    else jnp.float64)
    params = pipeline.geodesic_params_from_config(cfg, bh_m, bh_a)
    fparams = formula_model.formula_params_from_config(cfg)

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
        return jnp.sum(img["I_nu"])

    argnums = (0, 1) if args.pose else (0,)
    grad_fn = jax.jit(jax.value_and_grad(total_flux, argnums=argnums))

    n = args.res * args.res
    tile = args.tile
    idx = np.arange(n).reshape(args.res, args.res)
    order = idx.reshape(args.res // tile, tile, args.res // tile,
                        tile).transpose(0, 2, 1, 3).reshape(-1)
    P = jnp.asarray(np.asarray(rays.positions)[order])
    D = jnp.asarray(np.asarray(rays.directions)[order])
    M = jnp.asarray(np.asarray(rays.momentum_factors)[order])
    chunk = tile * tile
    cn0 = jnp.asarray(fparams.cn0, P.dtype)

    def run_all():
        outs = []
        for i in range(0, n, chunk):
            outs.append(grad_fn(cn0, P[i:i + chunk], D[i:i + chunk],
                                M[i:i + chunk]))
        jax.block_until_ready(outs)
        return outs

    t0 = time.perf_counter()
    outs = run_all()
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        outs = run_all()
        times.append(time.perf_counter() - t0)
    t = min(times)
    g_cn0 = sum(float(o[1][0]) for o in outs)
    assert np.isfinite(g_cn0)
    if args.pose:
        g_pos = np.concatenate([np.asarray(o[1][1]) for o in outs])
        assert np.isfinite(g_pos).all()
    print(json.dumps({
        "res": args.res, "steps": args.steps, "precision": args.precision,
        "mode": "forward+backward", "wrt": "cn0+pose" if args.pose else "cn0",
        "time_s": round(t, 2),
        "compile_s": round(compile_s, 1),
        "rays_per_s": round(n / t, 1),
    }))


if __name__ == "__main__":
    main()
