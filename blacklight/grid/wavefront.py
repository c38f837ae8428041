"""Wavefront (windowed, deduplicated) grid sampling.

The simulation path gathers one packed-corner column per (ray, step). On
hardware whose gathers cost per index rather than per byte, that bounds
the sampler (not measured on the H100; ROADMAP Design 2). But rays advance
~one cell per 3-7 steps and coherent ray bundles share cells heavily -
measured on the production bench workload, a 1024-ray subtile touches at
most ~800 UNIQUE cells over a 128-step window vs 131k naive per-sample
fetches (scripts/analyze_coherence.py). The wavefront sampler exploits
this:

  per (subtile, window):
    1. dedup the window's anchor-cell ids (sort + unique-rank + scatter),
    2. ONE packed-corner gather of the <= R unique columns from HBM,
    3. per step, expand each sample's 64-value corner column from the
       small table - by small-table gather or by an EXACT one-hot matmul
       (the f32 table is split into three bf16 parts that sum
       exactly; 0/1 one-hot rows make each partial product exact, so the
       selection reproduces f32 bits).

This replaces the per-(ray,step) HBM gather with per-window index work:
the HBM index count drops by ~W, and the per-step expansion runs at
matrix-unit or elementwise rates instead of the gather index rate.

No reference counterpart (the C++ code's sampling is host-sequential,
simulation_sampling.cpp:636-707); the sampled VALUES are bit-identical to
sample_grid's packed path - same locate, same packed table, same trilinear
+ positivity + fallback helpers (grid/sampling.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from blacklight.grid.sampling import (
    SamplerOptions, finalize_sample, locate_anchor, packed_named,
    sample_names)
from blacklight.ops import sks


def build_window_tables(ids, n_sub: int, capacity: int):
    """Per-subtile dedup of one window's flat anchor-cell ids.

    Args:
      ids: (B, W) int32 flat cell ids (clamped, always valid).
      n_sub: number of ray subtiles (B must divide evenly).
      capacity: table slots R per subtile.

    Returns:
      tables: (n_sub, R) int32 unique cell ids (padded slots repeat the
        last unique id - they are never referenced by `local` unless
        overflowed).
      local: (B, W) int32 per-sample slot into its subtile's table.
      overflow: () bool - some subtile saw more than R unique ids (slot
        R-1 then aliases several cells; the caller must fall back).
    """
    b, w = ids.shape
    bs = b // n_sub
    flat = ids.reshape(n_sub, bs * w)

    def build(one):
        m = one.shape[0]
        pos = jax.lax.iota(jnp.int32, m)
        s, p = jax.lax.sort_key_val(one, pos)
        newflag = jnp.concatenate(
            [jnp.ones((1,), jnp.int32),
             (s[1:] != s[:-1]).astype(jnp.int32)])
        rank = jnp.cumsum(newflag) - 1                    # 0-based unique rank
        over = rank[-1] >= capacity
        rank_c = jnp.minimum(rank, capacity - 1)
        table = jnp.full((capacity,), s[-1], jnp.int32).at[rank_c].set(s)
        local = jnp.zeros((m,), jnp.int32).at[p].set(rank_c)
        return table, local, over

    tables, local, over = jax.vmap(build)(flat)
    return tables, local.reshape(b, w), jnp.any(over)


def gather_window_columns(packed, tables):
    """Fetch the deduplicated packed-corner columns from HBM.

    packed: (P, C) corner-packed table (P = 8 * nvar); tables: (n_sub, R).
    Returns (n_sub, R, P) float32 window tables (small enough to stay in
    on-chip memory during the expansion step).
    """
    n_sub, cap = tables.shape
    cols = packed[:, tables.reshape(-1)]          # (P, n_sub * R)
    return jnp.moveaxis(cols.reshape(-1, n_sub, cap), 0, 2)


def _split_bf16x3(tables_vals):
    """Split f32 into three bf16 parts that sum back exactly.

    f32 has a 24-bit significand; three bf16s carry 3 x 8 bits, so
    hi + mid + lo reproduces the f32 value bit-for-bit (each residual is
    exactly representable: it fits 8 further significand bits). Exactness
    holds for x == 0 and 1e-30 <= |x| <= 1e38 (validated over 4M random
    f32 bit patterns): below that, `lo` falls under bf16's exponent floor
    (min normal ~1.18e-38, 2^-16 below `hi`); above it, `hi` overflows
    bf16's max (~3.39e38) to inf. _SPLIT_EXACT_LO/HI gate the domain and
    prep_fn folds a violation into the window overflow flag, falling back
    to the exact per-step path."""
    hi = tables_vals.astype(jnp.bfloat16)
    r1 = tables_vals - hi.astype(jnp.float32)
    mid = r1.astype(jnp.bfloat16)
    lo = (r1 - mid.astype(jnp.float32)).astype(jnp.bfloat16)
    return hi, mid, lo


_SPLIT_EXACT_LO = 1e-30
_SPLIT_EXACT_HI = 1e38


def _split_exact_ok(tables_vals):
    """True when every table value is in _split_bf16x3's exact domain."""
    a = jnp.abs(tables_vals)
    ok = (a == 0.0) | ((a >= _SPLIT_EXACT_LO) & (a <= _SPLIT_EXACT_HI))
    return jnp.all(ok)


def expand_onehot(split_tables, local, capacity: int):
    """Exact one-hot MXU expansion: (n_sub, bs) slots -> (P, n_sub * bs).

    split_tables: the _split_bf16x3 of (n_sub, R, P) window tables. The
    one-hot matrix is exact in bf16 (0.0/1.0), each partial product is an
    exact f32, and the three-part sum reconstructs the f32 table value
    exactly - selection without a gather, at MXU rates.
    """
    hi, mid, lo = split_tables
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, capacity), 2)
    oh = (local[:, :, None] == iota)
    oh_b = oh.astype(jnp.bfloat16)

    def mm(t):
        return jax.lax.dot_general(
            oh_b, t, (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32)   # (n_sub, bs, P)

    vals = mm(hi) + mm(mid) + mm(lo)
    n_sub, bs, p = vals.shape
    return vals.reshape(n_sub * bs, p).T


def build_brick_tables(i_m, j_m, k_m, use, n_sub: int, dims, brick):
    """Sort-free window "dedup": per-subtile dense bounding bricks.

    The sort-based `build_window_tables` costs O(bs * W * log^2) bitonic
    sort passes per subtile, which can outweigh the gathers it saves.
    This variant exploits the same coherence without sorting: the window's
    anchor cells of one coherent subtile fit a small (BK, BJ, BI) brick, so
    the "table" is simply the dense brick starting at the subtile's minimum
    anchor corner, fetched with one contiguous dynamic_slice (no per-index
    cost at all), and each sample's slot is plain address arithmetic.

    Args:
      i_m/j_m/k_m: (W, B) clamped anchor indices (single-block grid).
      use: (W, B) bool - samples that must land inside the brick (valid and
        on-grid; others get slot 0 and are excluded from the overflow test).
      n_sub: ray subtiles (B divides evenly).
      dims: (n_k, n_j, n_i) grid extents.
      brick: (BK, BJ, BI) static brick extents.

    Returns:
      origins: ((n_sub,) k0, j0, i0) int32 brick corners.
      slot: (W, n_sub, bs) int32 slot into the brick table.
      overflow: () bool - some used sample fell outside its brick.
    """
    n_k, n_j, n_i = dims
    bk, bj, bi = brick
    w, b = i_m.shape
    bs = b // n_sub

    def per_axis(a_m, n, extent):
        a = a_m.reshape(w, n_sub, bs)
        big = jnp.where(use.reshape(w, n_sub, bs), a, n)
        a0 = jnp.clip(jnp.min(big, axis=(0, 2)), 0, max(n - extent, 0))
        rel = a - a0[None, :, None]
        return a0, rel

    k0, rel_k = per_axis(k_m, n_k, bk)
    j0, rel_j = per_axis(j_m, n_j, bj)
    i0, rel_i = per_axis(i_m, n_i, bi)
    use_sub = use.reshape(w, n_sub, bs)
    out = ((rel_i < 0) | (rel_i >= bi) | (rel_j < 0) | (rel_j >= bj)
           | (rel_k < 0) | (rel_k >= bk))
    overflow = jnp.any(use_sub & out)
    slot = (jnp.clip(rel_k, 0, bk - 1) * bj
            + jnp.clip(rel_j, 0, bj - 1)) * bi + jnp.clip(rel_i, 0, bi - 1)
    slot = jnp.where(use_sub, slot, 0)
    return (k0, j0, i0), slot, overflow


def fetch_brick_columns(packed, origins, brick, dims):
    """Dense brick slabs from the packed-corner table: (n_sub, cap, P).

    One contiguous (strided) dynamic_slice per subtile - bandwidth-bound,
    zero per-index cost - instead of a gather of unique columns.
    """
    n_k, n_j, n_i = dims
    bk, bj, bi = brick
    p = packed.shape[0]
    packed4 = packed.reshape(p, n_k, n_j, n_i)
    k0, j0, i0 = origins
    zero = jnp.zeros((), jnp.int32)
    tabs = [
        jax.lax.dynamic_slice(packed4, (zero, k0[s], j0[s], i0[s]),
                              (p, bk, bj, bi)).reshape(p, bk * bj * bi).T
        for s in range(k0.shape[0])]
    return jnp.stack(tabs)


def make_wavefront_prep(grid, spin, opts: SamplerOptions, n_sub: int,
                        capacity: int, expand: str = "onehot",
                        mode: str = "dedup", brick=(8, 8, 16)):
    """Build (prep_fn, prims_fn) for geodesic.windowed_reduce.

    prep_fn(samples) dedups the window and fetches the unique packed
    columns; prims_fn (wrapped into the contribution by the caller)
    expands one step's corner columns and finishes the sample exactly like
    sample_grid's packed path.

    mode selects the window-table construction: "dedup" (sort + unique-rank
    + gather of unique columns, any block count) or "brick" (sort-free
    dense bounding bricks + contiguous slab fetch, single-block grids; the
    one-hot capacity becomes the brick volume).
    """
    if grid.prim_packed is None:
        raise ValueError("wavefront sampling needs the packed-corner table")
    nvar, n_b, n_k, n_j, n_i = grid.prim.shape
    if mode == "brick":
        if n_b != 1:
            raise ValueError("brick wavefront mode needs a single-block grid")
        brick = (min(brick[0], n_k), min(brick[1], n_j), min(brick[2], n_i))
        capacity = brick[0] * brick[1] * brick[2]
    names = sample_names(opts)
    ind = grid.ind

    def prep_fn(samples):
        w, b = samples.valid.shape
        pos = samples.pos.reshape(w * b, 4)
        valid = samples.valid.reshape(w * b)
        # Dead samples hold parked/terminal states; locate runs fine there
        # (finite algebra) and their values are discarded by `valid`.
        x, y, z = pos[:, 1], pos[:, 2], pos[:, 3]
        if grid.coords == "cks":
            r, th, ph = x, y, z
        else:
            r, th, ph = sks.cks_to_sks(x, y, z, spin)
        blk, (i_c, j_c, k_c), (i_m, j_m, k_m), (f_i, f_j, f_k), off_grid = \
            locate_anchor(grid, r, th, ph, n_b, n_i, n_j, n_k)
        if opts.interp:
            i_m = jnp.clip(i_m, 0, n_i - 2)
            j_m = jnp.clip(j_m, 0, n_j - 2)
            k_m = jnp.clip(k_m, 0, n_k - 2)
        else:
            # Nearest sampling reads the containing cell itself (the packed
            # table's first nvar rows are that cell's own values), matching
            # sample_grid's non-interp packed branch.
            i_m = jnp.clip(i_c, 0, n_i - 1)
            j_m = jnp.clip(j_c, 0, n_j - 1)
            k_m = jnp.clip(k_c, 0, n_k - 1)
        if mode == "brick":
            use = (valid & ~off_grid).reshape(w, b)
            origins, slot, overflow = build_brick_tables(
                i_m.reshape(w, b).astype(jnp.int32),
                j_m.reshape(w, b).astype(jnp.int32),
                k_m.reshape(w, b).astype(jnp.int32),
                use, n_sub, (n_k, n_j, n_i), brick)
            tables_vals = fetch_brick_columns(
                grid.prim_packed, origins, brick, (n_k, n_j, n_i))
            local_steps = slot
        else:
            anchor_flat = ((blk * n_k + k_m) * n_j + j_m) * n_i + i_m
            # Invalid/off-grid samples all point at cell 0 so they cannot
            # inflate the window's unique count.
            anchor_flat = jnp.where(valid & ~off_grid, anchor_flat, 0)

            ids_bw = anchor_flat.reshape(w, b).T.astype(jnp.int32)  # (B, W)
            tables, local, overflow = build_window_tables(
                ids_bw, n_sub, capacity)
            tables_vals = gather_window_columns(grid.prim_packed, tables)
            local_steps = local.T.reshape(w, n_sub, b // n_sub)

        aux_steps = {
            "local": local_steps,
            "f_i": f_i.reshape(w, b), "f_j": f_j.reshape(w, b),
            "f_k": f_k.reshape(w, b), "off_grid": off_grid.reshape(w, b),
        }
        if expand == "onehot":
            aux_const = {"split": _split_bf16x3(tables_vals)}
            overflow = overflow | ~_split_exact_ok(tables_vals)
        else:
            aux_const = {"tables_vals": tables_vals}
        return aux_steps, aux_const, overflow

    def prims_fn(aux_step, aux_const, dtype):
        if expand == "onehot":
            cols = expand_onehot(aux_const["split"], aux_step["local"],
                                 capacity)
        else:
            tv = aux_const["tables_vals"]
            got = jnp.take_along_axis(
                tv, aux_step["local"][..., None], axis=1)  # (n_sub, bs, P)
            n_sub_, bs, p = got.shape
            cols = got.reshape(n_sub_ * bs, p).T
        cols = cols.astype(dtype)
        named = packed_named(cols, aux_step["f_i"].astype(dtype),
                             aux_step["f_j"].astype(dtype),
                             aux_step["f_k"].astype(dtype), ind, opts, names)
        return finalize_sample(named, aux_step["off_grid"], opts, names,
                               dtype)

    return prep_fn, prims_fn
