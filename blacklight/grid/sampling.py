"""Device-side sampling of GRMHD grid data onto ray sample points.

Re-derivation of the reference's grid->ray sampler (src/radiation_integrator/
simulation_sampling.cpp:122-1044) as batched gathers that run *inside* the
fused ray scan: for each (B,) batch of CKS sample positions we convert to
simulation coordinates, locate the block and cell, build trilinear fractions
(intrablock interpolation with extrapolation near block edges, exactly the
simulation_interp=true / simulation_block_interp=false semantics at
simulation_sampling.cpp:495-516), and gather the 8 primitive-variable
corners. The reference's host-side precomputed index maps (sample_inds/
sample_fracs) never materialize - indices are cheap to recompute per step on
device, where the gather is the cost.

Off-grid samples get NaN (fallback_nan) or user fallback plasma values
(simulation_sampling.cpp:376-384, 676-707); interpolated rho/pgas/kappa that
come out non-positive fall back to the anchor-cell value (:826-832).
"""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp

from blacklight.grid.athena import SimulationGrid
from blacklight.ops import sks


# Corner order (dk, dj, di) matching the reference's 8-term trilinear sum
# (InterpolateSimple, simulation_sampling.cpp:1334-1351): mmm, mmp, mpm,
# mpp, pmm, pmp, ppm, ppp with letters ordered (k, j, i).
_CORNER_ORDER = ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
                 (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1))


@dataclasses.dataclass(frozen=True)
class SamplerOptions:
    interp: bool = True
    # Interpolate across block boundaries on multi-block (AMR) grids
    # (simulation_block_interp; reference FindNearbyInds/
    # InterpolateAdvanced, simulation_sampling.cpp:1068-1386)
    block_interp: bool = False
    fallback_nan: bool = True
    fallback_rho: float = 0.0
    fallback_pgas: float = 0.0
    fallback_kappa: float = 0.0
    has_kappa: bool = False
    # Slow light (simulation_sampling.cpp:297-349): camera time of the
    # snapshot being rendered, and whether to interpolate between slices
    snapshot_time: float = 0.0
    slow_interp: bool = False


def _locate(xf_row, xv_row, x):
    """Cell index + anchor + fraction along one dimension.

    xf_row: (n+1,) faces; xv_row: (n,) centers; x: (B,) coordinates.
    Mirrors simulation_sampling.cpp:488-516: i is the containing cell
    (first i with xf[i+1] >= x), the anchor i_m backs off by one when x is
    past the cell center (except at block edges), and the fraction may lie
    outside [0,1] near edges (extrapolation).

    The index comes from a branchless comparison-count instead of
    jnp.searchsorted (which can lower to a serialized binary-search loop),
    and the center-coordinate lookups come from one-hot multiply-reduces
    instead of (B,)-from-(n,) gathers, which also handle per-sample
    coordinate rows uniformly. Both choices come from a backend where
    small gathers were expensive; their A/B against searchsorted and
    plain gathers on the H100 is not measured yet.
    """
    n = xv_row.shape[-1]
    idx = jnp.sum((xf_row < x[..., None]).astype(jnp.int32), axis=-1)
    i = jnp.clip(idx - 1, 0, n - 1)

    iota = jnp.arange(n, dtype=jnp.int32)
    onehot = (iota == i[..., None]).astype(x.dtype)          # (B, n)
    xv_b = jnp.broadcast_to(xv_row, onehot.shape)
    xv_i = jnp.sum(onehot * xv_b, axis=-1)                   # xv[i]
    xv_im1 = jnp.sum(onehot * jnp.roll(xv_b, 1, axis=-1), axis=-1)
    xv_ip1 = jnp.sum(onehot * jnp.roll(xv_b, -1, axis=-1), axis=-1)

    use_i = (i == 0) | ((i != n - 1) & (x >= xv_i))
    i_m = jnp.where(use_i, i, i - 1)
    lo = jnp.where(use_i, xv_i, xv_im1)        # xv[i_m]
    hi = jnp.where(use_i, xv_ip1, xv_i)        # xv[i_m + 1]
    f = (x - lo) / (hi - lo)
    return i, i_m, f


def locate_anchor(grid: SimulationGrid, r, th, ph, n_b, n_i, n_j, n_k):
    """Spatial block/cell location + trilinear anchors for SKS/native
    coordinates (r, th, ph).

    The containing-cell search of the reference's sampling prep
    (simulation_sampling.cpp:352-516): block containment, per-axis cell
    index i, trilinear anchor i_m (backed off by one when the sample is
    past the cell center, except at block edges) and fraction f (may leave
    [0, 1] near edges). Shared by the per-step sampler (sample_grid) and
    the windowed wavefront sampler (grid/wavefront.py).

    Returns (b, (i, j, k), (i_m, j_m, k_m), (f_i, f_j, f_k), off_grid)
    with i_m/j_m/k_m UNclamped.
    """
    if grid.sks_map is not None:
        # FMKS: off-grid test in SKS via precomputed domain bounds
        # (simulation_sampling.cpp:192-197), then map (r, theta) to native
        # (x^1, x^2) by bilinear lookup in the inverse table
        # (simulation_sampling.cpp:397-412; bilinear here where the
        # reference interpolates x^1 in r only and x^2 in theta only).
        r_lo, r_hi, th_lo, th_hi, ph_lo, ph_hi = grid.bounds
        off_grid = ((r < r_lo) | (r > r_hi) | (th < th_lo) | (th > th_hi)
                    | (ph < ph_lo) | (ph > ph_hi))
        n2m, n1m = grid.sks_map.shape[1], grid.sks_map.shape[2]
        fi = (r - grid.map_r_in) / grid.map_dr
        fj = th / grid.map_dtheta
        i0 = jnp.clip(jnp.floor(fi).astype(jnp.int32), 0, n1m - 2)
        j0 = jnp.clip(jnp.floor(fj).astype(jnp.int32), 0, n2m - 2)
        wi = jnp.clip(fi - i0, 0.0, 1.0)
        wj = jnp.clip(fj - j0, 0.0, 1.0)
        q1 = ((1 - wi) * grid.sks_map[0, j0, i0]
              + wi * grid.sks_map[0, j0, i0 + 1])
        q2 = ((1 - wj) * ((1 - wi) * grid.sks_map[1, j0, i0]
                          + wi * grid.sks_map[1, j0, i0 + 1])
              + wj * ((1 - wi) * grid.sks_map[1, j0 + 1, i0]
                      + wi * grid.sks_map[1, j0 + 1, i0 + 1]))
        b = jnp.zeros(r.shape, dtype=jnp.int32)
        i, i_m, f_i = _locate(grid.x1f[0], grid.x1v[0], q1)
        j, j_m, f_j = _locate(grid.x2f[0], grid.x2v[0], q2)
        k, k_m, f_k = _locate(grid.x3f[0], grid.x3v[0], ph)
    elif n_b == 1:
        b = jnp.zeros(r.shape, dtype=jnp.int32)
        x1f, x1v = grid.x1f[0], grid.x1v[0]
        x2f, x2v = grid.x2f[0], grid.x2v[0]
        x3f, x3v = grid.x3f[0], grid.x3v[0]
        off_grid = ((r < x1f[0]) | (r > x1f[-1]) | (th < x2f[0]) | (th > x2f[-1])
                    | (ph < x3f[0]) | (ph > x3f[-1]))
        i, i_m, f_i = _locate(x1f, x1v, r)
        j, j_m, f_j = _locate(x2f, x2v, th)
        k, k_m, f_k = _locate(x3f, x3v, ph)
    else:
        # General multi-block path: containment scan over blocks (the
        # reference's linear search, simulation_sampling.cpp:352-394),
        # then per-sample row gathers for the block's coordinate arrays.
        contains = ((r[:, None] >= grid.x1f[None, :, 0])
                    & (r[:, None] <= grid.x1f[None, :, -1])
                    & (th[:, None] >= grid.x2f[None, :, 0])
                    & (th[:, None] <= grid.x2f[None, :, -1])
                    & (ph[:, None] >= grid.x3f[None, :, 0])
                    & (ph[:, None] <= grid.x3f[None, :, -1]))
        off_grid = ~jnp.any(contains, axis=-1)
        b = jnp.argmax(contains, axis=-1).astype(jnp.int32)
        i, i_m, f_i = jax.vmap(_locate)(grid.x1f[b], grid.x1v[b], r)
        j, j_m, f_j = jax.vmap(_locate)(grid.x2f[b], grid.x2v[b], th)
        k, k_m, f_k = jax.vmap(_locate)(grid.x3f[b], grid.x3v[b], ph)
    return b, (i, j, k), (i_m, j_m, k_m), (f_i, f_j, f_k), off_grid


def trilinear_weights(f_i, f_j, f_k):
    """The reference's 8-term corner weighting, in _CORNER_ORDER
    (InterpolateSimple, simulation_sampling.cpp:1334-1351)."""
    return [(1 - f_k) * (1 - f_j) * (1 - f_i),
            (1 - f_k) * (1 - f_j) * f_i,
            (1 - f_k) * f_j * (1 - f_i),
            (1 - f_k) * f_j * f_i,
            f_k * (1 - f_j) * (1 - f_i),
            f_k * (1 - f_j) * f_i,
            f_k * f_j * (1 - f_i),
            f_k * f_j * f_i]


def finalize_sample(named, off_grid, opts: SamplerOptions, names, pos_dtype):
    """Cast round-trip + off-grid fallback shared by every sampling path.

    The reference stores sampled values as float32 before the (double)
    coefficient math (SampleSimulation casts, simulation_sampling.cpp:
    836-844) - round-trip for parity. Off-grid fallback per
    simulation_sampling.cpp:376-384, 676-707: with fallback_nan the
    reference stores NaN; here values stay FINITE (a NaN primal would
    poison reverse-mode through every later product) and "nan_mask" tells
    consumers which samples to NaN-poison in outputs.
    """
    out = {}
    fb = {"rho": opts.fallback_rho,
          "pgas": opts.fallback_pgas,
          "kappa": opts.fallback_kappa,
          "uu1": 0.0, "uu2": 0.0, "uu3": 0.0,
          "bb1": 0.0, "bb2": 0.0, "bb3": 0.0}
    for name in names:
        v = named[name].astype(jnp.float32).astype(pos_dtype)
        out[name] = jnp.where(off_grid, fb[name], v)
    out["off_grid"] = off_grid
    out["nan_mask"] = off_grid if opts.fallback_nan \
        else jnp.zeros_like(off_grid)
    return out


def sample_names(opts: SamplerOptions):
    names = ["rho", "pgas", "uu1", "uu2", "uu3", "bb1", "bb2", "bb3"]
    if opts.has_kappa:
        names.append("kappa")
    return names


def packed_named(cols, f_i, f_j, f_k, ind, opts: SamplerOptions, names):
    """Trilinear blend of packed corner columns + positivity repair.

    cols: (8*nvar, B) - all 8 corner values of every variable for each
    sample's anchor cell, in _CORNER_ORDER blocks (athena.
    with_packed_corners layout). Returns the named value dict with
    interpolated rho/pgas/kappa repaired against the anchor (mmm) cell
    (simulation_sampling.cpp:821-827). Shared by sample_grid's packed
    branch and the wavefront sampler so their semantics cannot drift.
    """
    nvar = cols.shape[0] // 8
    if opts.interp:
        w = trilinear_weights(f_i, f_j, f_k)
        vals = sum(wc * cols[c * nvar:(c + 1) * nvar]
                   for c, wc in enumerate(w))
        anchor = cols[:nvar]
    else:
        vals = anchor = cols[:nvar]
    named = {}
    for name in names:
        v = vals[ind[name]]
        if opts.interp and name in ("rho", "pgas", "kappa"):
            v = jnp.where(v <= 0.0, anchor[ind[name]], v)
        named[name] = v
    return named


def sample_grid(grid: SimulationGrid, pos, spin, opts: SamplerOptions):
    """Sample primitives at CKS positions.

    Args:
      grid: device grid.
      pos: (B, 4) CKS sample positions.
      spin: black-hole spin.
      opts: sampler options.

    Returns:
      dict of (B,) sampled values keyed rho/pgas/[kappa]/uu1..3/bb1..3,
      plus "off_grid" (B,) bool. NaN/fallback already applied.
    """
    x, y, z = pos[..., 1], pos[..., 2], pos[..., 3]
    if grid.coords == "cks":
        # AthenaK: simulation coordinates ARE CKS; no conversion
        # (radiation_geometry.cpp:37-41 identity branch)
        r, th, ph = x, y, z
    else:
        r, th, ph = sks.cks_to_sks(x, y, z, spin)

    slow = grid.times is not None
    if slow:
        n_t, nvar, n_b, n_k, n_j, n_i = grid.prim.shape
        # Per-sample time slice selection (simulation_sampling.cpp:297-349):
        # times decrease with index; idx = first slice at or before x0
        times = grid.times
        x0 = pos[..., 0] + opts.snapshot_time
        # == searchsorted(-times, -x0, "left") without a serialized
        # binary-search lowering
        idx = jnp.sum((times > x0[..., None]).astype(jnp.int32), axis=-1)
        if opts.slow_interp:
            t_lo = jnp.clip(idx - 1, 0, n_t - 2)
            t_frac = (x0 - times[t_lo]) / (times[t_lo + 1] - times[t_lo])
            # Extrapolation clamps (camera side: hold slice 0; source side:
            # frac = 1 at the oldest pair)
            t_lo = jnp.where(x0 >= times[0], 0, t_lo)
            t_frac = jnp.where(x0 >= times[0], 0.0, t_frac)
            t_lo = jnp.where(x0 <= times[-1], n_t - 2, t_lo)
            t_frac = jnp.where(x0 <= times[-1], 1.0, t_frac)
        else:
            # Nearest slice (simulation_sampling.cpp:343-346)
            t_sel = jnp.clip(idx, 0, n_t - 1)
            prev_closer = (times[jnp.maximum(t_sel - 1, 0)] - x0) \
                <= (x0 - times[t_sel])
            t_sel = jnp.where((t_sel > 0) & prev_closer, t_sel - 1, t_sel)
            t_lo, t_frac = t_sel, None
    else:
        nvar, n_b, n_k, n_j, n_i = grid.prim.shape

    b, (i, j, k), (i_m, j_m, k_m), (f_i, f_j, f_k), off_grid = \
        locate_anchor(grid, r, th, ph, n_b, n_i, n_j, n_k)

    # Clamp anchors so gathers stay in-bounds even for off-grid samples
    # (their values are overwritten below).
    i_m = jnp.clip(i_m, 0, n_i - 2)
    j_m = jnp.clip(j_m, 0, n_j - 2)
    k_m = jnp.clip(k_m, 0, n_k - 2)

    use_block_interp = (opts.interp and opts.block_interp and n_b > 1
                        and grid.sks_map is None)
    sharded = grid.psum_axis is not None
    use_packed = (grid.prim_packed is not None and not slow
                  and not use_block_interp and not sharded)

    # --- Universal one-time-slice cell fetch ---------------------------
    # Every spatial path below (plain corners, exact/approximate
    # interblock, sharded masked-gather) reduces to fetches of
    # (block, k, j, i) cells from ONE time slice; slow light then runs the
    # spatial interpolation per slice and lerps the RESULTS, exactly the
    # reference's ordering (positivity repair per slice before the
    # temporal interpolation, simulation_sampling.cpp:736-792, 821-859,
    # 962-1036).
    if sharded:
        prim_loc = grid.prim_local

        def make_fetch(t_idx):
            def fetch(bb, kk, jj, ii):
                # Canonicalize through the FULL-layout flat index first:
                # the reference's AMR fine-neighbor formulas emit
                # out-of-range cell indices (e.g. i_sought == n_i for an
                # uncrossed midpoint axis, simulation_sampling.cpp:
                # 1301-1303) and rely on its contiguous Array aliasing the
                # read into the next row/plane. The replicated flat fetch
                # reproduces that aliasing automatically; the slab layout
                # would alias differently, so recover the canonical
                # (block, k, j, i) the full layout actually reads before
                # ownership masking.
                fi_full = ((bb * n_k + kk) * n_j + jj) * n_i + ii
                fi_full = jnp.clip(fi_full, 0, n_b * n_k * n_j * n_i - 1)
                cell = fi_full % (n_j * n_i)
                kf = (fi_full // (n_j * n_i)) % n_k
                bf = fi_full // (n_k * n_j * n_i)
                kloc = jnp.clip(kf - grid.k_shard_start, 0,
                                grid.k_shard_size - 1)
                fi = ((bf * grid.k_shard_size + kloc) * n_j * n_i) + cell
                own = ((kf >= grid.k_shard_start)
                       & (kf < grid.k_shard_start + grid.k_shard_size))
                if t_idx is None:
                    v = prim_loc[:, fi]                  # (nvar, B)
                else:
                    v = prim_loc[t_idx, :, fi].T         # (nvar, B)
                v = jnp.where(own[None, :], v, 0.0)
                return jax.lax.psum(v, grid.psum_axis)
            return fetch
    elif slow:
        prim_flat3 = grid.prim.reshape(n_t, nvar, -1)

        def make_fetch(t_idx):
            def fetch(bb, kk, jj, ii):
                fi = ((bb * n_k + kk) * n_j + jj) * n_i + ii
                return prim_flat3[t_idx, :, fi].T        # (nvar, B)
            return fetch
    else:
        prim_flat2 = grid.prim.reshape(nvar, -1)

        def make_fetch(t_idx):
            def fetch(bb, kk, jj, ii):
                fi = ((bb * n_k + kk) * n_j + jj) * n_i + ii
                return prim_flat2[:, fi]                 # (nvar, B)
            return fetch

    if use_packed:
        # Fast path: ONE column gather from the corner-packed table
        # (athena.with_packed_corners) fetches all 8 corners of all
        # variables in one index (see SimulationGrid.prim_packed).
        packed = grid.prim_packed

        if opts.interp:
            anchor_flat = ((b * n_k + k_m) * n_j + j_m) * n_i + i_m
            cols = packed[:, anchor_flat]                  # (8*nvar, B)
            w = trilinear_weights(f_i, f_j, f_k)
            vals = sum(wc * cols[c * nvar:(c + 1) * nvar]
                       for c, wc in enumerate(w))
            anchor = cols[:nvar]
        else:
            flat = ((b * n_k + k) * n_j + j) * n_i + i
            vals = packed[:nvar, :][:, flat]
            anchor = vals
    elif use_block_interp and grid.amr_table is not None:
        # EXACT cross-block trilinear interpolation (the reference's
        # interblock mode, simulation_sampling.cpp:505-552 + FindNearbyInds
        # :1068-1321 + InterpolateAdvanced :1365-1386): corner indices are
        # NOT clamped to the block; each out-of-block corner resolves to a
        # neighbor block at the same/coarser/finer refinement level through
        # the host-precomputed table (grid/amr.py), with phi periodicity
        # and constant extrapolation at the grid edge.
        rows1v, rows2v, rows3v = grid.x1v[b], grid.x2v[b], grid.x3v[b]

        def take(a, idx):
            return jnp.take_along_axis(a, idx[:, None], axis=1)[:, 0]

        xv_i = take(rows1v, i)
        xv_j = take(rows2v, j)
        xv_k = take(rows3v, k)
        # Unclamped anchors (":505-510"): i_m in [-1, n-1]
        i_mr = jnp.where(r >= xv_i, i, i - 1)
        j_mr = jnp.where(th >= xv_j, j, j - 1)
        k_mr = jnp.where(ph >= xv_k, k, k - 1)

        def ghost_fracs(rows_v, xv_all, xf_all, base, s, n):
            # Bracket positions with ghost mirrors (":516-521"). The upper
            # ghost reproduces the reference's literal x?v(b, n) read: the
            # flattened array's next element (= the next block's first
            # center; the reference's Array is contiguous so its
            # out-of-row-bounds read lands there), clamped at the very end.
            xv0 = xv_all[:, 0][b]
            xf0 = xf_all[:, 0][b]
            xv_last = xv_all[:, -1][b]
            xf_last = xf_all[:, -1][b]
            lo = jnp.where(base == -1, 2.0 * xf0 - xv0,
                           take(rows_v, jnp.clip(base, 0, n - 1)))
            # The reference's x?v(b, n) lands on the NEXT block's first
            # center in its contiguous Array; for the final block (where
            # that read is past the allocation) use the mirror through the
            # upper face instead.
            flat_v = xv_all.reshape(-1)
            last_block = b == (flat_v.shape[0] // n) - 1
            nxt = jnp.where(
                last_block, 2.0 * xf_last - xv_last,
                flat_v[jnp.minimum(b * n + n, flat_v.shape[0] - 1)])
            hi = jnp.where(base + 1 == n, 2.0 * nxt - xv_last,
                           take(rows_v, jnp.clip(base + 1, 0, n - 1)))
            return (s - lo) / (hi - lo)

        f_i = ghost_fracs(rows1v, grid.x1v, grid.x1f, i_mr, r, n_i)
        f_j = ghost_fracs(rows2v, grid.x2v, grid.x2f, j_mr, th, n_j)
        f_k = ghost_fracs(rows3v, grid.x3v, grid.x3f, k_mr, ph, n_k)

        table_flat = grid.amr_table.reshape(-1, grid.amr_table.shape[-1])
        parity = grid.loc_parity[b]                       # (B, 3)

        def corner_amr(dk, dj, di):
            cki = i_mr + di
            ckj = j_mr + dj
            ckk = k_mr + dk
            s_i = jnp.where(cki == -1, -1, jnp.where(cki == n_i, 1, 0))
            s_j = jnp.where(ckj == -1, -1, jnp.where(ckj == n_j, 1, 0))
            s_k = jnp.where(ckk == -1, -1, jnp.where(ckk == n_k, 1, 0))
            u_i = (cki > n_i // 2).astype(jnp.int32)
            u_j = (ckj > n_j // 2).astype(jnp.int32)
            u_k = (ckk > n_k // 2).astype(jnp.int32)
            dir_idx = (s_k + 1) * 9 + (s_j + 1) * 3 + (s_i + 1)
            half = u_k * 4 + u_j * 2 + u_i
            entry = table_flat[(b * 27 + dir_idx) * 8 + half]  # (B, 5)
            b_alt = entry[:, 0]
            case = entry[:, 1]
            eff = entry[:, 2:5]

            def axis_idx(ax, ck, u, n, c_idx, x, xv_c):
                e = eff[:, ax]
                par = parity[:, ax]
                # A crossed axis whose direction had no grid was clamped
                # onto the home block (":1224-1229"): the reference
                # reassigns the corner index to its safe value before the
                # cell-index formulas, so eff == 0 must use the CLAMPED
                # index (identity for genuinely in-range corners). The
                # upper flags stay raw-index-based (computed at entry).
                cs = jnp.clip(ck, 0, n - 1)
                same = jnp.where(e == 0, cs,
                                 jnp.where(e == -1, n - 1, 0))
                coarse = jnp.where(e == 0, (par * n + cs) >> 1,
                                   jnp.where(e == -1, n - 1, 0))
                fine = jnp.where(e == 0,
                                 jnp.where(u == 1, (cs - n // 2) * 2,
                                           cs * 2),
                                 jnp.where(e == -1, n - 2, 0))
                # ":1310-1312": nudge the fine cell toward the sample. A
                # crossed-but-existing axis compares its RAW index (-1 / n);
                # only the clamped case compares the safe one.
                ca = jnp.where(e == 0, cs, ck)
                adj = ((ca < c_idx)
                       | ((ca == c_idx) & (x > xv_c))).astype(jnp.int32)
                fine = fine + adj
                return jnp.where(case == 0, same,
                                 jnp.where(case == 1, coarse, fine))

            ii = axis_idx(0, cki, u_i, n_i, i, r, xv_i)
            jj = axis_idx(1, ckj, u_j, n_j, j, th, xv_j)
            kk = axis_idx(2, ckk, u_k, n_k, k, ph, xv_k)
            return b_alt, kk, jj, ii

        corner_idx = [corner_amr(dk, dj, di)
                      for dk, dj, di in _CORNER_ORDER]
    elif use_block_interp:
        # Approximate cross-block trilinear interpolation (fallback when no
        # AMR metadata is available to build the exact neighbor table):
        # where the in-block fraction leaves [0, 1] (sample in the outer
        # half of an edge cell), the missing bracket point lies in a
        # neighbor block. Its position is
        # taken as the mirror of the edge cell center through the block
        # face (exact for equal-size neighbors, the common AMR case), the
        # containing block is found by a global containment search with
        # phi periodicity, and the nearest cell there supplies the corner
        # value - the same decomposition as the reference's
        # FindNearbyInds + InterpolateAdvanced
        # (simulation_sampling.cpp:1068-1386), vectorized per corner.
        rows1f, rows1v = grid.x1f[b], grid.x1v[b]
        rows2f, rows2v = grid.x2f[b], grid.x2v[b]
        rows3f, rows3v = grid.x3f[b], grid.x3v[b]

        def take(a, idx):
            return jnp.take_along_axis(a, idx[:, None], axis=1)[:, 0]

        def bracket(rows_f, rows_v, base, f, s):
            lo = take(rows_v, base)
            hi = take(rows_v, base + 1)
            lo = jnp.where(f < 0.0, 2.0 * rows_f[:, 0] - rows_v[:, 0], lo)
            hi = jnp.where(f > 1.0, 2.0 * rows_f[:, -1] - rows_v[:, -1], hi)
            fr = (s - lo) / (hi - lo)
            return lo, hi, fr

        lo1, hi1, f_i = bracket(rows1f, rows1v, i_m, f_i, r)
        lo2, hi2, f_j = bracket(rows2f, rows2v, j_m, f_j, th)
        lo3, hi3, f_k = bracket(rows3f, rows3v, k_m, f_k, ph)
        two_pi = 2.0 * jnp.pi
        periodic_phi = grid.coords != "cks"

        def locate_nearest(c1, c2, c3):
            if periodic_phi:
                c3 = jnp.mod(c3, two_pi)
            cont = ((c1[:, None] >= grid.x1f[None, :, 0])
                    & (c1[:, None] <= grid.x1f[None, :, -1])
                    & (c2[:, None] >= grid.x2f[None, :, 0])
                    & (c2[:, None] <= grid.x2f[None, :, -1])
                    & (c3[:, None] >= grid.x3f[None, :, 0])
                    & (c3[:, None] <= grid.x3f[None, :, -1]))
            found = jnp.any(cont, axis=-1)
            bb = jnp.argmax(cont, axis=-1).astype(jnp.int32)

            def near(xf_all, c, n):
                rows = xf_all[bb]
                idx = jnp.sum((rows < c[:, None]).astype(jnp.int32), axis=-1)
                return jnp.clip(idx - 1, 0, n - 1)

            ii = near(grid.x1f, c1, n_i)
            jj = near(grid.x2f, c2, n_j)
            kk = near(grid.x3f, c3, n_k)
            return (bb, kk, jj, ii), found

        def corner_x(dk, dj, di):
            c1 = hi1 if di else lo1
            c2 = hi2 if dj else lo2
            c3 = hi3 if dk else lo3
            (bb, kk, jj, ii), found = locate_nearest(c1, c2, c3)
            bb = jnp.where(found, bb, b)
            kk = jnp.where(found, kk, k_m + dk)
            jj = jnp.where(found, jj, j_m + dj)
            ii = jnp.where(found, ii, i_m + di)
            return bb, kk, jj, ii

        corner_idx = [corner_x(dk, dj, di)
                      for dk, dj, di in _CORNER_ORDER]
    elif opts.interp:
        corner_idx = [(b, k_m + dk, j_m + dj, i_m + di)
                      for dk, dj, di in _CORNER_ORDER]
    else:
        corner_idx = [(b, k, j, i)]

    ind = grid.ind
    names = sample_names(opts)

    def assemble(vals_s, anchor_s):
        """Named values for one time slice with the positivity repair
        applied against the anchor cell (simulation_sampling.cpp:821-827;
        per slice BEFORE temporal interpolation, :736-792)."""
        named_s = {}
        for name in names:
            v = vals_s[ind[name]]
            if opts.interp and name in ("rho", "pgas", "kappa"):
                v = jnp.where(v <= 0.0, anchor_s[ind[name]], v)
            named_s[name] = v
        return named_s

    if use_packed:
        named = assemble(vals, anchor)
    else:
        def sample_slice(fetch):
            cs = [fetch(*ci) for ci in corner_idx]
            if len(cs) == 1:
                return assemble(cs[0], cs[0])
            w = trilinear_weights(f_i, f_j, f_k)
            vals_s = sum(wi * ci for wi, ci in zip(w, cs))
            return assemble(vals_s, cs[0])

        if slow and opts.slow_interp:
            d0 = sample_slice(make_fetch(t_lo))
            d1 = sample_slice(make_fetch(t_lo + 1))
            named = {nm: (1.0 - t_frac) * d0[nm] + t_frac * d1[nm]
                     for nm in d0}
        elif slow:
            named = sample_slice(make_fetch(t_lo))
        else:
            named = sample_slice(make_fetch(None))

    # User fallback values are used VERBATIM (the reference does so,
    # simulation_sampling.cpp:695-707, and 0.0 is legal input); divisions
    # by rho/pgas downstream clamp at the point of use instead
    # (models/synchrotron.py fluid_state).
    return finalize_sample(named, off_grid, opts, names, pos.dtype)
