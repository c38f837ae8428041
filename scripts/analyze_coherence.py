"""Measure ray/grid coherence statistics on the benchmark workload.

Design inputs for the windowed sampler (grid/wavefront.py): where the
sampler is bound by the rate of gather indices, the way past that floor
is to fetch each grid cell FEWER times. Two exploitable structures, both
measured here on the bench rays (rk4, 1024^2 camera, 2000 steps, mock
128x64x64 grid):

  1. ALONG-RAY runs: consecutive steps that stay inside the same cell need
     no refetch (identical corner values). Reported: mean run length and
     the per-(ray, window) unique-run count that sizes a windowed corner
     table.
  2. ACROSS-RAY sharing: coherent image tiles revisit the same cells.
     Reported: unique cells per (subtile, step) and per (subtile, window)
     vs the naive fetch count.

    python scripts/analyze_coherence.py [--res 1024] [--steps 2000]
"""

import argparse
import json
import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--tiles", default="center,mid,corner")
    ap.add_argument("--windows", default="64,128,256")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    n_r, n_th, n_ph = 128, 64, 64
    mock = f"/tmp/bench_mock_{n_r}x{n_th}x{n_ph}.athdf"
    root = pathlib.Path(__file__).resolve().parents[1]
    if not pathlib.Path(mock).exists():
        subprocess.run(
            [sys.executable, str(root / "scripts/generate_mock_simulation.py"),
             mock, "--n_r", str(n_r), "--n_th", str(n_th),
             "--n_ph", str(n_ph), "--r_min", "1.916", "--r_max", "52.2",
             "--pert_amp", "0.1"], check=True)

    from blacklight import read_config
    from blacklight import pipeline
    from blacklight.pipeline_simulation import load_grid
    from blacklight.pipeline import make_camera
    from blacklight.ops import geodesic as geo
    from blacklight.ops import sks

    fixtures = root / "tests/fixtures"
    cfg = read_config(str(fixtures / "golden_sim_rk4_32.input"))
    cfg.simulation_file = mock
    cfg.ray_max_steps = args.steps
    cfg.camera_resolution = args.res

    bh_m, bh_a, _ = pipeline.bh_mass_spin(cfg)
    grid, _ = load_grid(cfg, dtype=jax.numpy.float64)
    geom, rays, _ = make_camera(cfg, bh_m=bh_m, bh_a=bh_a,
                                dtype=jax.numpy.float64)
    params = pipeline.geodesic_params_from_config(cfg, bh_m, bh_a)

    x1f = np.asarray(grid.x1f[0])
    x2f = np.asarray(grid.x2f[0])
    x3f = np.asarray(grid.x3f[0])

    res = args.res
    sub = 32                      # dense subtile side (1024 rays)
    tile_px = {
        "center": (res // 2 - sub // 2, res // 2 - sub // 2),
        "mid": (res // 2 + res // 8, res // 2 + res // 8),
        "corner": (8, 8),
    }

    trace = jax.jit(lambda p, d: geo.trace_geodesics(p, d, params)[0])
    windows = [int(w) for w in args.windows.split(",")]
    report = {}
    for name in args.tiles.split(","):
        r0, c0 = tile_px[name]
        pix = (np.arange(r0, r0 + sub)[:, None] * res
               + np.arange(c0, c0 + sub)[None, :]).reshape(-1)
        P = np.asarray(rays.positions)[pix]
        D = np.asarray(rays.directions)[pix]
        samples = trace(P, D)
        pos = np.asarray(samples.pos)          # (S, B, 4)
        valid = np.asarray(samples.valid)      # (S, B)
        S, B = valid.shape

        x, y, z = pos[..., 1], pos[..., 2], pos[..., 3]
        r, th, ph = (np.asarray(a) for a in sks.cks_to_sks(x, y, z, bh_a))
        ii = np.clip(np.searchsorted(x1f, r, "right") - 1, 0, n_r - 1)
        jj = np.clip(np.searchsorted(x2f, th, "right") - 1, 0, n_th - 1)
        kk = np.clip(np.searchsorted(x3f, ph, "right") - 1, 0, n_ph - 1)
        cell = ((kk * n_th + jj) * n_r + ii).astype(np.int64)
        cell[~valid] = -1

        # 1. Along-ray run statistics (valid samples only)
        run_counts = []
        total_valid = 0
        for b in range(B):
            c = cell[:, b]
            c = c[c >= 0]
            if len(c) == 0:
                continue
            total_valid += len(c)
            run_counts.append(1 + int(np.sum(c[1:] != c[:-1])))
        runs = int(np.sum(run_counts))
        stats = {
            "valid_samples_per_ray": total_valid / max(B, 1),
            "runs_per_ray": runs / max(B, 1),
            "mean_run_len": total_valid / max(runs, 1),
        }

        # 2. Unique runs per (ray, window) - sizes the per-ray corner table
        for W in windows:
            per_ray_runs = []
            for s0 in range(0, S, W):
                blk = cell[s0:s0 + W]                     # (W, B)
                changes = np.sum((blk[1:] != blk[:-1]) & (blk[1:] >= 0),
                                 axis=0)
                has = np.any(blk >= 0, axis=0).astype(np.int64)
                per_ray_runs.append(changes + has)
            pr = np.stack(per_ray_runs)                   # (n_win, B)
            stats[f"ray_runs_w{W}_mean"] = float(pr.mean())
            stats[f"ray_runs_w{W}_p99"] = float(np.quantile(pr, 0.99))
            stats[f"ray_runs_w{W}_max"] = int(pr.max())

        # 3. Cross-ray sharing: unique cells per (subtile, step) and
        #    per (subtile, window); total unique for the whole subtile
        uniq_per_step = [len(np.unique(cell[s][cell[s] >= 0]))
                         for s in range(0, S, max(S // 256, 1))]
        stats["subtile_uniq_per_step_mean"] = float(np.mean(uniq_per_step))
        stats["subtile_uniq_per_step_max"] = int(np.max(uniq_per_step))
        for W in windows:
            uw = []
            for s0 in range(0, S, W):
                blk = cell[s0:s0 + W]
                u = np.unique(blk[blk >= 0])
                uw.append(len(u))
            stats[f"subtile_uniq_w{W}_mean"] = float(np.mean(uw))
            stats[f"subtile_uniq_w{W}_max"] = int(np.max(uw))
        stats["subtile_uniq_total"] = int(len(np.unique(cell[cell >= 0])))
        stats["naive_fetches"] = int(total_valid * B / max(B, 1) * 1)
        report[name] = {k: (round(v, 2) if isinstance(v, float) else v)
                        for k, v in stats.items()}
        print(name, json.dumps(report[name]), flush=True)


if __name__ == "__main__":
    main()
