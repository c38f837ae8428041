"""Microbenchmark: XLA-side primitives for the windowed "wavefront" sampler.

Design under test (grid/wavefront.py): instead of one packed-corner
gather per (ray, step), batch W steps per window, dedup the window's
touched cells per ray subtile (scripts/analyze_coherence.py counts them),
gather only unique packed columns from HBM, and expand per-(ray, step)
values from the small window table.

Measures, on the GPU (or --cpu):
  (a) jnp.sort / sort_key_val rates at window sizes (the dedup build),
  (b) the FULL window-table build: sort + unique-flag + cumsum + scatter
      (table ids and per-sample local ids),
  (c) one-hot expansion: build (B, R) one-hot + matmul against (R, 64)
      table, f32-HIGHEST vs 3-pass bf16 splits, per step,
  (d) XLA gather layouts: row-major (C, 64) row fetch vs column-major
      (64, C) column fetch vs small-table (R, 64) row fetch.

    python scripts/bench_wavefront_micro.py [--cpu]
"""

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    C = 128 * 64 * 64
    rng = np.random.default_rng(0)

    def emit(name, **kv):
        print(name, json.dumps({k: (round(v, 3) if isinstance(v, float)
                                    else v) for k, v in kv.items()}),
              flush=True)

    def timeit_scan(step_fn, init_carry, k, reps=3):
        """seconds per iteration of step_fn inside one jitted scan."""

        @jax.jit
        def run(carry):
            def body(c, _):
                return step_fn(c), 0.0
            c, _ = jax.lax.scan(body, carry, None, length=k)
            return sum(jnp.sum(leaf.astype(jnp.float32))
                       for leaf in jax.tree.leaves(c))
        np.asarray(run(init_carry))
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            np.asarray(run(init_carry))
            times.append(time.perf_counter() - t0)
        return min(times) / k

    # ---- (a) sort rates ------------------------------------------------
    for n in (131072, 2097152):
        ids0 = jnp.asarray(rng.integers(0, C, (n,)), jnp.int32)

        def step_sort(c, n=n):
            ids, acc = c
            s = jnp.sort(ids)
            return ((ids + 1000003) % C, acc + s[0] + s[-1])

        dt = timeit_scan(step_sort,
                         (ids0, jnp.zeros((), jnp.int32)), k=8)
        emit(f"sort_i32_n{n}", us=dt * 1e6, m_elem_per_s=n / dt / 1e6)

        def step_sortkv(c, n=n):
            ids, acc = c
            pos = jax.lax.iota(jnp.int32, n)
            s, p = jax.lax.sort_key_val(ids, pos)
            return ((ids + 1000003) % C, acc + s[0] + p[-1])

        dt = timeit_scan(step_sortkv,
                         (ids0, jnp.zeros((), jnp.int32)), k=8)
        emit(f"sortkv_i32_n{n}", us=dt * 1e6, m_elem_per_s=n / dt / 1e6)

    # ---- (b) full window-table build -----------------------------------
    # Input: ids (B, W) flat cell ids for one window. Output: table ids
    # (R,) padded with the last value, local ids (B, W) into the table.
    B, W = 16384, 128
    for n_sub, R in ((16, 1024), (1, 8192)):
        bs = B // n_sub          # rays per subtile
        idsw0 = jnp.asarray(
            rng.integers(0, C, (n_sub, bs * W)), jnp.int32)

        def build(ids, R=R):
            # ids: (n, ) one subtile-window's flat cell ids
            n = ids.shape[0]
            pos = jax.lax.iota(jnp.int32, n)
            s, p = jax.lax.sort_key_val(ids, pos)
            newflag = jnp.concatenate(
                [jnp.ones((1,), jnp.int32),
                 (s[1:] != s[:-1]).astype(jnp.int32)])
            rank = jnp.cumsum(newflag) - 1                 # (n,)
            rank_c = jnp.minimum(rank, R - 1)
            table = jnp.zeros((R,), jnp.int32).at[rank_c].set(s)
            local = jnp.zeros((n,), jnp.int32).at[p].set(rank_c)
            return table, local

        def step_build(c):
            ids, acc = c
            tab, loc = jax.vmap(build)(ids)
            return ((ids + 1000003) % C,
                    acc + tab.sum() + loc.sum())

        dt = timeit_scan(step_build,
                         (idsw0, jnp.zeros((), jnp.int32)), k=8)
        emit(f"window_build_sub{n_sub}_R{R}",
             us_per_window=dt * 1e6, us_per_step_equiv=dt / W * 1e6)

    # ---- (c) one-hot expansion per step --------------------------------
    for n_sub, R in ((16, 1024), (16, 512), (4, 2048)):
        bs = B // n_sub
        tabs = jnp.asarray(rng.standard_normal((n_sub, R, 64)), jnp.float32)
        lid0 = jnp.asarray(rng.integers(0, R, (n_sub, bs)), jnp.int32)

        def step_oh_f32(c, R=R):
            lid, acc = c
            iota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, R), 2)
            oh = (lid[:, :, None] == iota).astype(jnp.float32)
            vals = jnp.einsum("sbr,srv->sbv", oh, tabs,
                              precision=jax.lax.Precision.HIGHEST)
            return ((lid + 7) % R, acc + vals.sum())

        dt = timeit_scan(step_oh_f32,
                         (lid0, jnp.zeros((), jnp.float32)), k=64)
        emit(f"onehot_f32hi_sub{n_sub}_R{R}", us_per_step=dt * 1e6,
             m_lookup_per_s=B / dt / 1e6)

        def step_oh_bf16(c, R=R):
            lid, acc = c
            iota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, R), 2)
            oh = (lid[:, :, None] == iota).astype(jnp.bfloat16)
            hi = tabs.astype(jnp.bfloat16)
            mid = (tabs - hi.astype(jnp.float32)).astype(jnp.bfloat16)
            lo = ((tabs - hi.astype(jnp.float32))
                  - mid.astype(jnp.float32)).astype(jnp.bfloat16)
            f = lambda t: jnp.einsum(
                "sbr,srv->sbv", oh, t,
                preferred_element_type=jnp.float32)
            vals = f(hi) + f(mid) + f(lo)
            return ((lid + 7) % R, acc + vals.sum())

        dt = timeit_scan(step_oh_bf16,
                         (lid0, jnp.zeros((), jnp.float32)), k=64)
        emit(f"onehot_bf16x3_sub{n_sub}_R{R}", us_per_step=dt * 1e6,
             m_lookup_per_s=B / dt / 1e6)

    # ---- (d) gather layouts --------------------------------------------
    tab_rows = jnp.asarray(rng.standard_normal((C, 64)), jnp.float32)
    tab_cols = jnp.asarray(tab_rows.T)
    idx0 = jnp.asarray(rng.integers(0, C, (B,)), jnp.int32)

    def step_rows(c):
        ix, acc = c
        got = tab_rows[ix, :]                    # (B, 64) row fetch
        return ((ix + 1000003) % C, acc + got.sum())

    dt = timeit_scan(step_rows, (idx0, jnp.zeros((), jnp.float32)), k=32)
    emit("gather_rowmajor_C", us_per_step=dt * 1e6, m_idx_per_s=B / dt / 1e6)

    def step_cols(c):
        ix, acc = c
        got = tab_cols[:, ix]                    # (64, B) column fetch
        return ((ix + 1000003) % C, acc + got.sum())

    dt = timeit_scan(step_cols, (idx0, jnp.zeros((), jnp.float32)), k=32)
    emit("gather_colmajor_C", us_per_step=dt * 1e6, m_idx_per_s=B / dt / 1e6)

    small = jnp.asarray(rng.standard_normal((1024, 64)), jnp.float32)
    sidx0 = jnp.asarray(rng.integers(0, 1024, (B,)), jnp.int32)

    def step_small(c):
        ix, acc = c
        got = small[ix, :]
        return ((ix + 7) % 1024, acc + got.sum())

    dt = timeit_scan(step_small, (sidx0, jnp.zeros((), jnp.float32)), k=64)
    emit("gather_rowmajor_R1024", us_per_step=dt * 1e6,
         m_idx_per_s=B / dt / 1e6)


if __name__ == "__main__":
    main()
