"""Persistent XLA compilation cache.

The reference pays no compile cost (ahead-of-time C++); here every cold
process pays XLA compilation per executable - minutes for the adaptive
path's bucketed shapes. Wiring jax's persistent compilation cache makes
every run after the first reuse the serialized executables from disk.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, that directory is the cache and
nothing else is chosen here. Otherwise the cache lives at a fixed path
inside the checkout (``<repo>/.jax_cache``, git-ignored): never a path made
from a temp name, a pid or the time, which would never be found again.

Call sites: ``cli.main``, bench.py and chip_smoke.py. Tests do not enable
it (they want hermetic compiles).
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Point jax's persistent compilation cache at its directory (see the
    module docstring) and return it. Safe to call more than once."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    # Cache everything: the default 1 s floor would skip the many small
    # per-bucket adaptive executables whose *dispatch* is cheap but whose
    # cold compile dominates end-to-end time.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir
