"""Polarized-path benchmark (BASELINE.md protocol).

Renders the golden_polarized_rk4 physics (mock Athena++ grid, rk4
geodesics, 512-step rays, thermal synchrotron, full IQUV) as ONE jit call
per batch size and reports rays/s. Run on the GPU:

    python scripts/bench_polarized.py [--steps 512] [--sizes 64,128]

The per-call time at B=4096 vs B=16384 diagnoses whether the scan body is
batch-bound (healthy) or op-overhead-bound (the round-1 pathology:
~25 ms/step fixed cost from (B,F,4,4) tile waste).
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--sizes", default="64,128")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--precision", default="float32")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.precision == "float64":
        jax.config.update("jax_enable_x64", True)

    from blacklight import read_config
    from blacklight.pipeline_simulation import make_simulation_renderer

    fixtures = pathlib.Path(__file__).resolve().parents[1] / "tests/fixtures"
    cfg = read_config(str(fixtures / "golden_polarized_rk4_32.input"))
    cfg.simulation_file = str(fixtures / "mock_small.athdf")
    cfg.precision = args.precision
    cfg.ray_max_steps = args.steps

    for res in [int(s) for s in args.sizes.split(",")]:
        cfg.camera_resolution = res
        render_fn, geom, rays, frequencies, mass = make_simulation_renderer(
            cfg)
        n = res * res
        t0 = time.perf_counter()
        img = render_fn(rays.positions, rays.directions,
                        rays.momentum_factors)
        compile_s = time.perf_counter() - t0
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            img = render_fn(rays.positions, rays.directions,
                            rays.momentum_factors)
            times.append(time.perf_counter() - t0)
        t = min(times)
        import numpy as np
        assert np.isfinite(np.nanmax(np.asarray(img["I_nu"]))), "bad image"
        print(json.dumps({
            "B": n, "steps": args.steps, "precision": args.precision,
            "time_s": round(t, 3), "compile_s": round(compile_s, 1),
            "rays_per_s": round(n / t, 1),
            "ms_per_step": round(t / args.steps * 1e3, 3),
        }))


if __name__ == "__main__":
    main()
