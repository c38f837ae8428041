"""Adaptive-refinement end-to-end timing (BASELINE.md row).

Runs the example_adaptive-style workload (simulation model, 128^2 root
camera, 8x8 blocks, refinement levels) cold and warm on the current
backend and reports wall-clock per phase.

    python scripts/bench_adaptive.py [--levels 2]
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from blacklight.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    root = pathlib.Path(__file__).resolve().parents[1]
    n_r, n_th, n_ph = 128, 64, 64
    mock = f"/tmp/bench_mock_{n_r}x{n_th}x{n_ph}.athdf"
    if not pathlib.Path(mock).exists():
        subprocess.run(
            [sys.executable, str(root / "scripts/generate_mock_simulation.py"),
             mock, "--n_r", str(n_r), "--n_th", str(n_th),
             "--n_ph", str(n_ph), "--r_min", "1.916", "--r_max", "52.2",
             "--pert_amp", "0.1"], check=True)

    from blacklight import pipeline, read_config

    cfg = read_config(str(root / "tests/fixtures/golden_adaptive_32.input"))
    cfg.simulation_file = mock
    cfg.precision = "float32"
    cfg.camera_resolution = 128
    cfg.ray_max_steps = 2000
    cfg.adaptive_max_level = args.levels
    cfg.adaptive_block_size = 8
    cfg.output_file = "/tmp/bench_adaptive_out.npz"

    t0 = time.perf_counter()
    arrays = pipeline.run(cfg, quiet=True)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    arrays = pipeline.run(cfg, quiet=True)
    warm = time.perf_counter() - t0
    n_levels = int(arrays.get("adaptive_num_levels", [0])[0])
    blocks = [int(v) for v in arrays.get("adaptive_num_blocks", [])]
    print(json.dumps({
        "res": 128, "block": 8, "max_level": args.levels,
        "levels": n_levels, "blocks_per_level": blocks,
        "cold_s": round(cold, 1), "warm_s": round(warm, 1),
    }))


if __name__ == "__main__":
    main()
