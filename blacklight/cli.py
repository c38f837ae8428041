"""Command-line entry point: ``python -m blacklight <input file>``.

Mirrors the reference driver (src/blacklight.cpp:31-273): one positional
input-file argument, a run loop over snapshots, friendly per-stage errors,
exit code 1 on failure.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or argv[0] in ("-h", "--help"):
        print("Usage: python -m blacklight <input_file>", file=sys.stderr)
        return 1 if len(argv) != 1 else 0

    from blacklight.utils.errors import BlacklightError

    try:
        from blacklight.utils.config import read_config
        cfg = read_config(argv[0])

        # Host thread count for the native OpenMP IO kernels
        # (blacklight.cpp:77 omp_set_num_threads); must be set before the
        # shared library is first loaded.
        if cfg.num_threads is not None:
            import os
            os.environ.setdefault("OMP_NUM_THREADS", str(cfg.num_threads))

        # Configure precision before any array work.
        import jax
        if (cfg.precision or "float64") == "float64":
            jax.config.update("jax_enable_x64", True)

        from blacklight.utils.cache import enable_compilation_cache
        enable_compilation_cache()

        from blacklight import pipeline
        from blacklight.constants import ModelType

        multiple = (cfg.model_type == ModelType.simulation
                    and cfg.require("simulation_multiple"))
        for n in range(cfg.num_runs):
            snapshot = None
            if multiple:
                if cfg.require("slow_light_on"):
                    snapshot = n
                else:
                    snapshot = cfg.require("simulation_start") + n
            pipeline.run(cfg, snapshot=snapshot)
    except (BlacklightError, OSError) as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
