"""Benchmark: rays/s on one GPU for the reference formula example at 1024^2
(dp, float32), through the served renderer (pipeline.make_formula_renderer,
the function pipeline.run and the CLI call).

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "rays/s", "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": ...}}

Exits non-zero when JAX finds no GPU: a number from another device is not
this benchmark's number.

Baseline: the reference C++ binary (OpenMP, 4 threads as configured in its
example_formula.input) renders the same physics at 128^2 in 46.6 s on a
CPU host (40.4 s geodesics + 6.2 s RT) = 351.5 rays/s. vs_baseline is
ours / 351.5.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

REFERENCE_RAYS_PER_S = 16384 / 46.6
RESOLUTION = 1024
REPEATS = 3


def main() -> int:
    import jax

    devices = jax.devices()
    if any(d.platform != "gpu" for d in devices):
        print(f"bench.py needs a GPU; JAX found {devices}", file=sys.stderr)
        return 2

    import numpy as np

    from blacklight import pipeline, read_config
    from blacklight.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    cfg = read_config(str(pathlib.Path(__file__).parent
                          / "tests/fixtures/golden_formula_32.input"))
    cfg.camera_resolution = RESOLUTION
    cfg.precision = "float32"
    render_fn, _, rays, _, _ = pipeline.make_formula_renderer(cfg)

    def render():
        return render_fn(rays.positions, rays.directions,
                         rays.momentum_factors)

    image = render()  # compile + first run
    if not np.isfinite(np.nanmax(image["I_nu"])):
        print("non-finite image", file=sys.stderr)
        return 1
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        render()
        times.append(time.perf_counter() - t0)
    rays_per_s = RESOLUTION * RESOLUTION / float(np.median(times))

    print(json.dumps({
        "metric": f"rays/s formula dp float32 {RESOLUTION}^2 "
                  "make_formula_renderer",
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / REFERENCE_RAYS_PER_S, 2),
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind,
                   "count": len(devices)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
