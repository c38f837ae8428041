"""Slow-light support: sliding window of time slices.

Re-derivation of the reference's slow-light machinery
(src/simulation_reader/simulation_reader.cpp:211-303): for each output
snapshot, scan simulation dumps forward until one covers the camera time
snapshot_time = slow_t_start + slow_dt * snapshot, then hold the
slow_chunk_size most recent dumps as a time window. Sample-time
interpolation happens on device in the sampler (grid/sampling.py), exactly
where the reference's per-sample t_ind/t_frac logic lives
(simulation_sampling.cpp:297-349).

Instead of the reference's swap-shift of in-memory arrays, files are
loaded through a small mtime-validated cache, which achieves the same
"read only new files" behavior without stateful array surgery.
"""

from __future__ import annotations

import os
import re

import jax.numpy as jnp
import numpy as np

from blacklight.utils.errors import BlacklightError, blacklight_warning

EXTRAPOLATION_TOLERANCE = 1.0  # reference simulation_reader.hpp:99

_grid_cache: dict = {}
_time_cache: dict = {}
_GRID_CACHE_MAX = 24


def format_filename(template: str, file_number: int) -> str:
    """{Nd}-pattern filename (simulation_reader.cpp:870-904)."""
    m = re.search(r"\{([0-9]*)d\}", template)
    if m is None:
        raise BlacklightError("Invalid simulation_file for multiple files.")
    width = int(m.group(1)) if m.group(1) else 0
    return template[:m.start()] + f"{file_number:0{width}d}" + template[m.end():]


def peek_time(path: str, fmt) -> float:
    """Read only the snapshot time from a dump (cheap per format)."""
    from blacklight.constants import SimulationFormat
    from blacklight.grid.athena import import_h5py

    key = (path, os.path.getmtime(path))
    if key in _time_cache:
        return _time_cache[key]
    if fmt == SimulationFormat.athena:
        h5py = import_h5py()
        with h5py.File(path, "r") as f:
            t = float(f.attrs["Time"])
    elif fmt == SimulationFormat.iharm3d:
        h5py = import_h5py()
        with h5py.File(path, "r") as f:
            t = float(np.asarray(f["t"]).reshape(-1)[0])
    elif fmt == SimulationFormat.athenak:
        with open(path, "rb") as f:
            f.readline()
            f.readline()
            line = f.readline().decode(errors="replace")
            if not line.startswith("  time="):
                raise BlacklightError("Invalid AthenaK file header.")
            t = float(line[len("  time="):])
    else:  # harm3d: first ASCII token
        with open(path, "rb") as f:
            tok = b""
            c = f.read(1)
            while c in b" \t\r\n" and c:
                c = f.read(1)
            while c not in b" \t\r\n" and c:
                tok += c
                c = f.read(1)
            t = float(tok)
    _time_cache[key] = t
    return t


def _load_single_cached(cfg, path: str, dtype):
    from blacklight.pipeline_simulation import load_grid_file

    key = (path, os.path.getmtime(path), str(dtype))
    if key in _grid_cache:
        return _grid_cache[key]
    grid = load_grid_file(cfg, path, dtype=dtype)
    if len(_grid_cache) >= _GRID_CACHE_MAX:
        _grid_cache.pop(next(iter(_grid_cache)))
    _grid_cache[key] = grid
    return grid


def load_slow_window(cfg, snapshot: int, dtype=jnp.float64):
    """Build the time-window grid for one output snapshot.

    Returns a SimulationGrid whose prim has a leading time axis
    (T, nvar, n_b, k, j, i) and whose times field holds the (decreasing)
    slice times; plus the snapshot_time.
    """
    import dataclasses

    fmt = cfg.require("simulation_format")
    template = cfg.require("simulation_file")
    start = cfg.require("simulation_start")
    end = cfg.require("simulation_end")
    chunk = cfg.require("slow_chunk_size")
    if chunk < 2:
        raise BlacklightError("Must have slow_chunk_size of at least 2.")
    if chunk > end - start + 1:
        raise BlacklightError(
            "Not enough simulation files for given slow_chunk_size.")
    snapshot_time = cfg.require("slow_t_start") + cfg.require("slow_dt") * snapshot

    # Scan forward for the first file at or past the camera time
    # (simulation_reader.cpp:218-249)
    latest = start + chunk - 1
    latest_time = peek_time(format_filename(template, latest), fmt)
    while latest_time < snapshot_time and latest < end:
        latest += 1
        latest_time = peek_time(format_filename(template, latest), fmt)
    if latest_time < snapshot_time - EXTRAPOLATION_TOLERANCE:
        raise BlacklightError(
            f"Snapshot {snapshot} at time {snapshot_time} would require "
            f"significant extrapolation beyond file {end}.")
    if latest_time < snapshot_time:
        blacklight_warning(
            f"Snapshot {snapshot} at time {snapshot_time} requires moderate "
            "extrapolation.")

    # Window: file numbers latest, latest-1, ..., latest-chunk+1 so that
    # times[0] is the most recent slice (simulation_reader.cpp:290-303)
    numbers = [latest - i for i in range(chunk)]
    grids = [_load_single_cached(cfg, format_filename(template, n), dtype)
             for n in numbers]
    times = np.array([g.time for g in grids])
    if not np.all(np.diff(times) < 0):
        raise BlacklightError("Slow-light file times are not increasing.")

    prim = jnp.stack([g.prim for g in grids])
    base = grids[0]
    grid = dataclasses.replace(base, prim=prim,
                               times=jnp.asarray(times, dtype=dtype))
    return grid, snapshot_time
