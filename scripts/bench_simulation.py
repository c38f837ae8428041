"""Simulation-path (thermal synchrotron) throughput benchmark.

BASELINE.md protocol: mock GRMHD grid (default 128x64x64), rk4 geodesics,
2000-step rays, unpolarized thermal RT, 1024^2 camera dispatched in
128x128 tiles. Run on the GPU:

    python scripts/bench_simulation.py [--res 1024] [--grid 128,64,64]

The mock snapshot is generated once into output/ (git-ignored).
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
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--tile", type=int, default=128,
                    help="dispatch tile side")
    ap.add_argument("--chunk", type=int, default=16384,
                    help="rays per dispatch call")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--integrator", choices=["dp", "rk4", "rk2"],
                    default=None, help="override the config's integrator")
    ap.add_argument("--grid", default="128,64,64")
    ap.add_argument("--freqs", type=int, default=1,
                    help="number of image frequencies (true-color = 10)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--precision", default="float32")
    ap.add_argument("--wavefront", action="store_true",
                    help="use the windowed wavefront sampler (A/B; not "
                         "measured on the H100)")
    ap.add_argument("--no-wavefront", action="store_true",
                    help="(default) force the per-step-scan sampler")
    ap.add_argument("--no-batch", action="store_true",
                    help="wavefront without window-batched coefficients "
                         "(A/B baseline)")
    ap.add_argument("--wf-mode", choices=["brick", "dedup"], default=None,
                    help="window-table construction (A/B)")
    ap.add_argument("--wf-window", type=int, default=None)
    ap.add_argument("--wf-brick", default=None,
                    help="BK,BJ,BI brick extents (brick mode)")
    args = ap.parse_args()

    n_r, n_th, n_ph = (int(s) for s in args.grid.split(","))
    root = pathlib.Path(__file__).resolve().parents[1]
    (root / "output").mkdir(exist_ok=True)
    mock = str(root / "output" / f"bench_mock_{n_r}x{n_th}x{n_ph}.athdf")
    if not pathlib.Path(mock).exists():
        subprocess.run(
            [sys.executable, str(root / "scripts/generate_mock_simulation.py"),
             mock, "--n_r", str(n_r), "--n_th", str(n_th),
             "--n_ph", str(n_ph), "--r_min", "1.916", "--r_max", "52.2",
             "--pert_amp", "0.1"], check=True)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.precision == "float64":
        jax.config.update("jax_enable_x64", True)
    import numpy as np

    from blacklight import read_config
    from blacklight import pipeline_simulation
    from blacklight.pipeline_simulation import make_simulation_renderer

    if args.wf_mode:
        pipeline_simulation.WAVEFRONT_MODE = args.wf_mode
    if args.wf_window:
        pipeline_simulation.WAVEFRONT_WINDOW = args.wf_window
    if args.wf_brick:
        pipeline_simulation.WAVEFRONT_BRICK = tuple(
            int(s) for s in args.wf_brick.split(","))

    fixtures = root / "tests/fixtures"
    cfg = read_config(str(fixtures / "golden_sim_rk4_32.input"))
    cfg.simulation_file = mock
    cfg.precision = args.precision
    cfg.ray_max_steps = args.steps
    if args.integrator:
        from blacklight.constants import RayIntegrator
        cfg.ray_integrator = getattr(RayIntegrator, args.integrator)
    cfg.camera_resolution = args.res
    if args.freqs > 1:
        # true-color style log-spaced band (example_true_color.input)
        cfg.image_num_frequencies = args.freqs
        cfg.image_frequency_start = 1.0e11
        cfg.image_frequency_end = 1.0e12
        from blacklight.constants import FrequencySpacing
        cfg.image_frequency_spacing = FrequencySpacing.log

    use_wf = args.wavefront and not args.no_wavefront
    render_fn, geom, rays, frequencies, mass = make_simulation_renderer(
        cfg, wavefront=use_wf, wavefront_batch=not args.no_batch)
    res = args.res
    tile = args.tile
    n = res * res
    idx = np.arange(n).reshape(res, res)
    order = idx.reshape(res // tile, tile, res // tile,
                        tile).transpose(0, 2, 1, 3).reshape(-1)
    P = np.asarray(rays.positions)[order]
    D = np.asarray(rays.directions)[order]
    M = np.asarray(rays.momentum_factors)[order]
    chunk = max(tile * tile, args.chunk)

    def render_all():
        outs = []
        for i in range(0, n, chunk):
            outs.append(render_fn(P[i:i + chunk], D[i:i + chunk],
                                  M[i:i + chunk]))
        return outs

    t0 = time.perf_counter()
    outs = render_all()
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        outs = render_all()
        times.append(time.perf_counter() - t0)
    t = min(times)
    i_img = np.concatenate([np.asarray(o["I_nu"])[:, 0] for o in outs])
    assert np.isfinite(np.nanmax(i_img)), "bad image"
    print(json.dumps({
        "res": res, "steps": args.steps, "grid": args.grid,
        "integrator": args.integrator or "rk4",
        "freqs": args.freqs, "tile": tile,
        "chunk": chunk,
        "wavefront": use_wf,
        "wavefront_batch": use_wf and not args.no_batch,
        "wf_mode": pipeline_simulation.WAVEFRONT_MODE if use_wf else None,
        "wf_window": pipeline_simulation.WAVEFRONT_WINDOW,
        "wf_brick": list(pipeline_simulation.WAVEFRONT_BRICK),
        "precision": args.precision, "time_s": round(t, 2),
        "compile_s": round(compile_s, 1),
        "rays_per_s": round(n / t, 1),
    }))


if __name__ == "__main__":
    main()
