"""Athena++ .athdf snapshot loader (host side, h5py).

Covers the layout the reference reads in its from-scratch HDF5 parser
(src/simulation_reader/simulation_reader.cpp:593-781 + VerifyVariablesAthena
:1141-1217): datasets 'prim' (rho, press, vel1-3) and 'B' (Bcc1-3) with
per-block face/center coordinate arrays. Unlike the reference's custom
parser, host-side decoding uses h5py; the loaded grid becomes device arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from blacklight.utils.errors import BlacklightError


@dataclasses.dataclass(frozen=True)
class SimulationGrid:
    """Device-resident GRMHD snapshot.

    prim is (n_var, n_b, n_k, n_j, n_i) float32 with variable order matching
    the reference's combined prim+B indexing; `ind` maps names to slots.
    """

    prim: jnp.ndarray
    x1f: jnp.ndarray    # (n_b, n_i+1)
    x1v: jnp.ndarray    # (n_b, n_i)
    x2f: jnp.ndarray
    x2v: jnp.ndarray
    x3f: jnp.ndarray
    x3v: jnp.ndarray
    ind: dict
    time: float
    # Coordinate system of the face/center arrays: "sks" (spherical
    # Kerr-Schild, incl. FMKS native via sks_map below) or "cks"
    # (AthenaK Cartesian Kerr-Schild, x1=x/x2=y/x3=z).
    coords: str = "sks"
    # FMKS grids keep native (x^1, x^2) coordinate arrays; the sampler maps
    # SKS (r, theta) -> native via this lookup table (the reference's
    # sks_map, simulation_geometry.cpp:330-407 / simulation_sampling.cpp:
    # 397-412). None for grids whose coordinate arrays are already SKS.
    sks_map: Optional[jnp.ndarray] = None   # (2, n2, n1): x1, x2 at uniform (r, th)
    map_r_in: float = 0.0
    map_dr: float = 0.0
    map_dtheta: float = 0.0
    # SKS-coordinate domain bounds (r/th/ph min,max) for the off-grid test
    # in the FMKS case (simulation_geometry.cpp:47-58). None: use face arrays.
    bounds: Optional[tuple] = None
    # Slow light: when set, prim has a leading time axis (T, nvar, ...) and
    # times holds the (decreasing) slice times (simulation_reader.cpp:211-303)
    times: Optional[jnp.ndarray] = None
    # Corner-packed copy (8*nvar, n_cells) float32 for the fast sampler:
    # column s holds ALL EIGHT trilinear corner values of every variable
    # for anchor cell s (rows grouped corner-major, corner index
    # c = dk*4 + dj*2 + di = shift of ((dk*n_j + dj)*n_i + di) cells).
    # One 64-row column gather replaces the 8x8 per-corner gathers, for
    # 8x the snapshot's device footprint: it pays where gathers cost per
    # index rather than per byte. Its A/B against plain 8-corner gathers
    # on the H100 is not measured yet. Built by with_packed_corners().
    prim_packed: Optional[jnp.ndarray] = None
    # Var-major local slab (nvar, n_b*k_shard_size*n_j*n_i) for spatially
    # sharded grids (parallel/grid_sharding.py) - sharding exists for
    # snapshots too big to replicate, so it keeps the 1x-memory layout.
    prim_local: Optional[jnp.ndarray] = None
    # AMR metadata (host numpy; Athena++/AthenaK only): per-block refinement
    # level, (i, j, k) logical location at that level, and the root phi
    # grid size (simulation_reader.cpp:697-712).
    levels: Optional[np.ndarray] = None
    locations: Optional[np.ndarray] = None
    n3_root: int = 0
    # Device AMR neighbor table for exact cross-level interblock sampling
    # (grid/amr.py build_neighbor_table): (n_b, 27, 8, 5) int32 + per-block
    # per-axis location parities (n_b, 3). Built by grid/amr.with_amr_table.
    amr_table: Optional[jnp.ndarray] = None
    loc_parity: Optional[jnp.ndarray] = None
    # Spatial grid sharding (parallel/grid_sharding.py): when set, prim_local
    # holds only this device's phi(k)-slab of k_shard_size planes starting at
    # global plane k_shard_start (a traced scalar inside shard_map), and
    # every corner gather is psum-reduced over mesh axis `psum_axis` (each
    # corner is owned by exactly one shard, so the reduction is exact).
    k_shard_start: Optional[object] = None
    k_shard_size: Optional[int] = None
    psum_axis: Optional[str] = None

    @property
    def n_blocks(self):
        return self.prim.shape[1]


def _grid_flatten(g: "SimulationGrid"):
    children = (g.prim, g.x1f, g.x1v, g.x2f, g.x2v, g.x3f, g.x3v,
                g.sks_map, g.times, g.prim_packed, g.prim_local,
                g.amr_table, g.loc_parity, g.k_shard_start,
                g.levels, g.locations)
    aux = (tuple(sorted(g.ind.items())), g.time, g.coords,
           g.map_r_in, g.map_dr, g.map_dtheta, g.bounds, g.n3_root,
           g.k_shard_size, g.psum_axis)
    return children, aux


def _grid_unflatten(aux, children):
    (ind_items, time, coords, map_r_in, map_dr, map_dtheta, bounds,
     n3_root, k_shard_size, psum_axis) = aux
    (prim, x1f, x1v, x2f, x2v, x3f, x3v, sks_map, times, prim_packed,
     prim_local, amr_table, loc_parity, k_shard_start, levels,
     locations) = children
    return SimulationGrid(
        prim=prim, x1f=x1f, x1v=x1v, x2f=x2f, x2v=x2v, x3f=x3f, x3v=x3v,
        ind=dict(ind_items), time=time, coords=coords, sks_map=sks_map,
        map_r_in=map_r_in, map_dr=map_dr, map_dtheta=map_dtheta,
        bounds=bounds, times=times, prim_packed=prim_packed,
        prim_local=prim_local, levels=levels, locations=locations,
        n3_root=n3_root, amr_table=amr_table, loc_parity=loc_parity,
        k_shard_start=k_shard_start, k_shard_size=k_shard_size,
        psum_axis=psum_axis)


# SimulationGrid is a jax pytree: the big device arrays (primitive tables,
# coordinates, AMR/neighbor tables) are CHILDREN so a jitted renderer can
# take the grid as an ARGUMENT instead of closure-capturing it - closure
# capture embeds the snapshot (up to GBs with the packed table) as an HLO
# constant, which bloats executables and compile requests. Host-only
# metadata rides in aux_data.
jax.tree_util.register_pytree_node(SimulationGrid, _grid_flatten,
                                   _grid_unflatten)


def with_packed_corners(grid: SimulationGrid,
                        max_bytes: int = 4 << 30) -> SimulationGrid:
    """Attach the corner-packed primitive table used by the fast sampler
    (see the prim_packed field note for the gather economics).

    Row c*nvar + v of the packed table is variable v's plane shifted by
    corner c's (dk, dj, di) offset, so gathering ONE column at the anchor
    cell yields every trilinear corner of every variable. Shifts stay
    within a block for clamped anchors (k_m <= n_k-2 etc.); the final
    cells of the table (shifts past the end) are edge-clamped and only
    reachable from anchors that off-grid handling overwrites anyway.

    Skipped for slow-light windows and when the 8x footprint would exceed
    max_bytes (the legacy per-var gather path handles those).
    """
    if grid.times is not None or grid.prim_packed is not None:
        return grid
    nvar, n_b, n_k, n_j, n_i = grid.prim.shape
    n_cells = n_b * n_k * n_j * n_i
    if 8 * nvar * n_cells * 4 > max_bytes:
        return grid
    flat = grid.prim.reshape(nvar, n_cells)
    rows = []
    for dk in (0, 1):
        for dj in (0, 1):
            for di in (0, 1):
                shift = (dk * n_j + dj) * n_i + di
                if shift == 0:
                    rows.append(flat)
                else:
                    rows.append(jnp.concatenate(
                        [flat[:, shift:],
                         jnp.repeat(flat[:, -1:], shift, axis=1)], axis=1))
    return dataclasses.replace(grid, prim_packed=jnp.concatenate(rows, axis=0))


def import_h5py():
    """The h5py module, which the HDF5 formats (Athena++, iharm3d) need and
    the other formats do not; a missing install is a user-facing error."""
    try:
        import h5py
    except ImportError as exc:
        raise BlacklightError(
            "Reading HDF5 snapshots (Athena++ .athdf, iharm3d) needs the "
            "h5py package, which is not installed.") from exc
    return h5py


def load_athdf(path: str, kappa_name: Optional[str] = None,
               dtype=jnp.float64) -> SimulationGrid:
    """Load an Athena++ .athdf file."""
    h5py = import_h5py()

    with h5py.File(path, "r") as f:
        dataset_names = [n.decode() for n in f.attrs["DatasetNames"]]
        num_variables = list(f.attrs["NumVariables"])
        variable_names = [n.decode() for n in f.attrs["VariableNames"]]
        time = float(f.attrs["Time"])

        # Stack datasets in order, tracking the global variable offset
        arrays = []
        for name in dataset_names:
            arrays.append(np.asarray(f[name], dtype=np.float32))
        prim = np.concatenate(arrays, axis=0)

        ind = {}
        wanted = {"rho": "rho", "pgas": "press", "uu1": "vel1", "uu2": "vel2",
                  "uu3": "vel3", "bb1": "Bcc1", "bb2": "Bcc2", "bb3": "Bcc3"}
        if kappa_name is not None:
            wanted["kappa"] = kappa_name
        for key, var in wanted.items():
            if var not in variable_names:
                raise BlacklightError(
                    f'Unable to locate "{var}" slice of "prim" in data file.')
            ind[key] = variable_names.index(var)

        x1f = np.asarray(f["x1f"], dtype=np.float64)
        x1v = np.asarray(f["x1v"], dtype=np.float64)
        x2f = np.asarray(f["x2f"], dtype=np.float64)
        x2v = np.asarray(f["x2v"], dtype=np.float64)
        x3f = np.asarray(f["x3f"], dtype=np.float64)
        x3v = np.asarray(f["x3v"], dtype=np.float64)

        # AMR metadata (simulation_reader.cpp:697-712): per-block refinement
        # levels and logical locations, plus the phi root-grid size that
        # sets n_3_level for periodic neighbor lookups
        # (simulation_sampling.cpp:85-93).
        levels = np.asarray(f["Levels"], dtype=np.int32) \
            if "Levels" in f else None
        locations = np.asarray(f["LogicalLocations"], dtype=np.int64) \
            if "LogicalLocations" in f else None
        n3_root = int(f.attrs["RootGridSize"][2]) \
            if "RootGridSize" in f.attrs else 0

    return SimulationGrid(
        prim=jnp.asarray(prim),
        x1f=jnp.asarray(x1f, dtype=dtype), x1v=jnp.asarray(x1v, dtype=dtype),
        x2f=jnp.asarray(x2f, dtype=dtype), x2v=jnp.asarray(x2v, dtype=dtype),
        x3f=jnp.asarray(x3f, dtype=dtype), x3v=jnp.asarray(x3v, dtype=dtype),
        ind=ind, time=time, levels=levels, locations=locations,
        n3_root=n3_root)
