"""Exact AMR cross-level interblock sampling support.

The reference resolves every trilinear corner that leaves its mesh block
with FindNearbyInds (src/radiation_integrator/simulation_sampling.cpp:
1068-1321): the neighbor block may be at the same refinement level, one
level coarser, or one level finer; phi neighbors wrap the periodic
boundary (SKS only); directions with no grid fall back to constant
extrapolation (the corner clamps onto the home block).

Device-side factorization: the *block-resolution* part of that logic
depends only on (home block, which axes crossed, which half of the block
the sample sits in) - a finite key space - so it precomputes on the host
into a dense (n_b, 27, 8, 4)-entry table (`build_neighbor_table`). The
remaining *cell-index* arithmetic depends on runtime indices and is a few
integer ops done on device per corner (grid/sampling.py). This mirrors
the reference's own split of "compute indices once" from "gather every
snapshot" (SURVEY section 7).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from blacklight.utils.errors import BlacklightError

# Table field layout (int32):
#   0: resolved neighbor block index b_alt
#   1: case code: 0 = same level, 1 = coarser, 2 = finer
#   2..4: effective per-axis crossing (-1, 0, +1) AFTER off-grid clamping,
#         order (di, dj, dk)
TABLE_FIELDS = 5


def _d2(x):
    """C++ truncating division by 2 (toward zero): (-1)/2 == 0 in C++ but
    -1 in Python floor division - the reference's coarser-level location
    arithmetic relies on truncation (simulation_sampling.cpp:1118-1121)."""
    return x // 2 if x >= 0 else -((-x) // 2)


def _find_nearby_block(levels, locations, n_i, n_j, n_k, n_3_level,
                       periodic_phi, b, di, dj, dk, ui, uj, uk):
    """Host transcription of FindNearbyInds' block-resolution logic
    (simulation_sampling.cpp:1068-1321) for one (direction, half) key.

    di/dj/dk in {-1, 0, +1} say whether the corner index is below, inside,
    or above the home block's valid range; ui/uj/uk are the reference's
    upper_i/j/k flags (corner index > n/2). Returns
    (b_alt, case, eff_di, eff_dj, eff_dk).
    """
    n_b = len(levels)
    level = int(levels[b])
    li, lj, lk = (int(locations[b, 0]), int(locations[b, 1]),
                  int(locations[b, 2]))
    max_level = int(levels.max())

    def blocks_at(lev):
        return [bb for bb in range(n_b) if levels[bb] == lev]

    # --- Per-axis existence checks (":1099-1211"): does the grid continue
    # in each crossed direction at same/coarser/finer level?
    def x1_exists():
        for bb in range(n_b):
            la, ia, ja, ka = (int(levels[bb]), int(locations[bb, 0]),
                              int(locations[bb, 1]), int(locations[bb, 2]))
            if la == level and ia == (li - 1 if di == -1 else li + 1) \
                    and ja == lj and ka == lk:
                return True
            if la == level - 1 \
                    and ia == (_d2(li - 1) if di == -1 else _d2(li + 1)) \
                    and ja == _d2(lj) and ka == _d2(lk):
                return True
            if la == level + 1 \
                    and ia == (li * 2 - 1 if di == -1 else li * 2 + 2) \
                    and ja == (lj * 2 + 1 if uj else lj * 2) \
                    and ka == (lk * 2 + 1 if uk else lk * 2):
                return True
        return False

    def x2_exists():
        for bb in range(n_b):
            la, ia, ja, ka = (int(levels[bb]), int(locations[bb, 0]),
                              int(locations[bb, 1]), int(locations[bb, 2]))
            if la == level and ia == li \
                    and ja == (lj - 1 if dj == -1 else lj + 1) and ka == lk:
                return True
            if la == level - 1 and ia == li // 2 \
                    and ja == (_d2(lj - 1) if dj == -1 else _d2(lj + 1)) \
                    and ka == _d2(lk):
                return True
            if la == level + 1 \
                    and ia == (li * 2 + 1 if ui else li * 2) \
                    and ja == (lj * 2 - 1 if dj == -1 else lj * 2 + 2) \
                    and ka == (lk * 2 + 1 if uk else lk * 2):
                return True
        return False

    def x3_exists():
        for bb in range(n_b):
            la, ia, ja, ka = (int(levels[bb]), int(locations[bb, 0]),
                              int(locations[bb, 1]), int(locations[bb, 2]))
            if la == level and ia == li and ja == lj \
                    and ka == (lk - 1 if dk == -1 else lk + 1):
                return True
            if la == level - 1 and ia == _d2(li) and ja == _d2(lj) \
                    and ka == (_d2(lk - 1) if dk == -1 else _d2(lk + 1)):
                return True
            if la == level + 1 \
                    and ia == (li * 2 + 1 if ui else li * 2) \
                    and ja == (lj * 2 + 1 if uj else lj * 2) \
                    and ka == (lk * 2 - 1 if dk == -1 else lk * 2 + 2):
                return True
            # Periodic wrap (":1183-1211")
            if periodic_phi and dk == -1 and lk == 0:
                if la == level and ia == li and ja == lj \
                        and ka == n_3_level[la] - 1:
                    return True
                if la == level - 1 and ia == _d2(li) and ja == _d2(lj) \
                        and ka == n_3_level[la] - 1:
                    return True
                if la == level + 1 and ia == (li * 2 + 1 if ui else li * 2) \
                        and ja == (lj * 2 + 1 if uj else lj * 2) \
                        and ka == n_3_level[la] - 1:
                    return True
            if periodic_phi and dk == 1 and lk == n_3_level[level] - 1:
                if la == level and ia == li and ja == lj and ka == 0:
                    return True
                if la == level - 1 and ia == _d2(li) and ja == _d2(lj) \
                        and ka == 0:
                    return True
                if la == level + 1 and ia == (li * 2 + 1 if ui else li * 2) \
                        and ja == (lj * 2 + 1 if uj else lj * 2) and ka == 0:
                    return True
        return False

    # Constant extrapolation where the grid ends (":1224-1229")
    if di != 0 and not x1_exists():
        di = 0
    if dj != 0 and not x2_exists():
        dj = 0
    if dk != 0 and not x3_exists():
        dk = 0

    phi_wrap_lo = periodic_phi and dk == -1 and lk == 0
    phi_wrap_hi = periodic_phi and dk == 1 and lk == n_3_level[level] - 1

    def seek(lev, ia, ja, ka):
        for bb in range(n_b):
            if int(levels[bb]) == lev and int(locations[bb, 0]) == ia \
                    and int(locations[bb, 1]) == ja \
                    and int(locations[bb, 2]) == ka:
                return bb
        return None

    # Same level (":1232-1258")
    ia = li + di
    ja = lj + dj
    ka = lk + dk
    if phi_wrap_lo:
        ka = n_3_level[level] - 1
    if phi_wrap_hi:
        ka = 0
    bb = seek(level, ia, ja, ka)
    if bb is not None:
        return bb, 0, di, dj, dk

    # Coarser level (":1260-1288")
    if level - 1 >= 0:
        ia = _d2(li + di) if di != 0 else _d2(li)
        ja = _d2(lj + dj) if dj != 0 else _d2(lj)
        ka = _d2(lk + dk) if dk != 0 else _d2(lk)
        if phi_wrap_lo:
            ka = n_3_level[level - 1] - 1
        if phi_wrap_hi:
            ka = 0
        bb = seek(level - 1, ia, ja, ka)
        if bb is not None:
            return bb, 1, di, dj, dk

    # Finer level (":1290-1316")
    ia = li * 2 + di + (1 if ui else 0)
    ja = lj * 2 + dj + (1 if uj else 0)
    ka = lk * 2 + dk + (1 if uk else 0)
    if phi_wrap_lo and level + 1 <= max_level:
        ka = n_3_level[level + 1] - 1
    if phi_wrap_hi:
        ka = 0
    bb = seek(level + 1, ia, ja, ka)
    if bb is not None:
        return bb, 2, di, dj, dk

    raise BlacklightError("Grid interpolation failed.")


def build_neighbor_table(levels, locations, n_i, n_j, n_k, n3_root,
                         periodic_phi):
    """Dense neighbor table for every (block, crossing, half) combination.

    Returns (table, loc_parity):
      table: (n_b, 27, 8, TABLE_FIELDS) int32 indexed by
        [b, (dk+1)*9 + (dj+1)*3 + (di+1), uk*4 + uj*2 + ui]
      loc_parity: (n_b, 3) int32, locations % 2 per axis (the coarser-level
        cell-index offset, simulation_sampling.cpp:1281-1283).
    """
    levels = np.asarray(levels, dtype=np.int64)
    locations = np.asarray(locations, dtype=np.int64)
    n_b = len(levels)
    max_level = int(levels.max())
    n_3_level = [max(n3_root // n_k, 1) << lev for lev in range(max_level + 1)]

    table = np.zeros((n_b, 27, 8, TABLE_FIELDS), dtype=np.int32)
    for b in range(n_b):
        for dk in (-1, 0, 1):
            for dj in (-1, 0, 1):
                for di in (-1, 0, 1):
                    dir_idx = (dk + 1) * 9 + (dj + 1) * 3 + (di + 1)
                    for half in range(8):
                        ui, uj, uk = bool(half & 1), bool(half & 2), \
                            bool(half & 4)
                        # Keys the runtime can never produce (a crossed axis
                        # determines its upper flag: index -1 is never upper,
                        # index n always is) get a benign home-block entry.
                        reachable = ((di == 0 or ui == (di > 0))
                                     and (dj == 0 or uj == (dj > 0))
                                     and (dk == 0 or uk == (dk > 0)))
                        if not reachable:
                            table[b, dir_idx, half] = (b, 0, 0, 0, 0)
                            continue
                        try:
                            b_alt, case, ei, ej, ek = _find_nearby_block(
                                levels, locations, n_i, n_j, n_k, n_3_level,
                                periodic_phi, b, di, dj, dk, ui, uj, uk)
                        except BlacklightError:
                            # The reference throws "Grid interpolation
                            # failed." only if a ray actually queries such
                            # a corner; an eager table build must stay
                            # tolerant of blocks whose neighborhoods are
                            # never sampled (e.g. non-tiling sentinel
                            # blocks). Fall back to constant extrapolation
                            # on the home block.
                            b_alt, case, ei, ej, ek = b, 0, 0, 0, 0
                        table[b, dir_idx, half] = (b_alt, case, ei, ej, ek)
    loc_parity = (locations % 2).astype(np.int32)
    return table, loc_parity


def with_amr_table(grid):
    """Attach the device neighbor table to a SimulationGrid (no-op when AMR
    metadata is absent or the grid is single-block)."""
    import jax.numpy as jnp

    if grid.amr_table is not None or grid.levels is None \
            or grid.locations is None or grid.n_blocks <= 1:
        return grid
    nvar, n_b, n_k, n_j, n_i = grid.prim.shape[-5:]
    table, parity = build_neighbor_table(
        grid.levels, grid.locations, n_i, n_j, n_k, grid.n3_root,
        periodic_phi=grid.coords != "cks")
    return dataclasses.replace(
        grid, amr_table=jnp.asarray(table), loc_parity=jnp.asarray(parity))
