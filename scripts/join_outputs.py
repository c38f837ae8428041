#!/usr/bin/env python
"""Merge outputs from multiple blacklight runs into one npz.

Capability parity with the reference's join_outputs.py (168 lines): given
several npz outputs of the same camera (e.g. runs refined over different
forced regions, or reruns at deeper adaptive levels), take root arrays from
the first file and the union of adaptive blocks across all files
(first-file-wins on duplicates), writing a single self-consistent npz.
"""

from __future__ import annotations

import argparse

import numpy as np

QUANTITIES = ("rho", "n_e", "p_gas", "Theta_e", "B", "sigma", "beta_inverse")
DEFAULT_NAMES = (
    ["positions", "directions", "I_nu", "Q_nu", "U_nu", "V_nu", "time",
     "length", "lambda", "emission", "tau", "crossings", "rendering"]
    + [f"lambda_ave_{q}" for q in QUANTITIES]
    + [f"emission_ave_{q}" for q in QUANTITIES]
    + [f"tau_int_{q}" for q in QUANTITIES])

# Which axis of an adaptive per-level array indexes blocks
def _block_axis(name: str, multifreq: bool) -> int:
    if name in ("positions", "directions", "time", "length", "crossings"):
        return 0
    if name == "rendering":
        return 2
    return 1 if multifreq else 0


def join(inputs, names=None) -> dict:
    names_specified = names is not None
    names = list(names) if names_specified else list(DEFAULT_NAMES)

    data = {}
    with np.load(inputs[0]) as f:
        data["mass_msun"] = f["mass_msun"]
        data["width"] = f["width"]
        data["frequency"] = f["frequency"]
        names_present = []
        for name in names:
            if name in f.files:
                data[name] = f[name]
                names_present.append(name)
            elif names_specified:
                raise KeyError(name)
    multifreq = len(data["frequency"]) > 1

    # Union of adaptive blocks, first occurrence wins (reference :98-110)
    per_file = []
    num_levels = 0
    any_adaptive = False
    for path in inputs:
        with np.load(path) as f:
            n_lvl = int(f["adaptive_num_levels"][0]) \
                if "adaptive_num_levels" in f.files else 0
            locs = {n: np.asarray(f[f"adaptive_block_locs_{n}"])
                    for n in range(1, n_lvl + 1)}
            any_adaptive |= "adaptive_num_blocks" in f.files
        per_file.append((path, n_lvl, locs))
        num_levels = max(num_levels, n_lvl)

    merged_locs = {n: [] for n in range(1, num_levels + 1)}
    take = {path: {n: [] for n in range(1, num_levels + 1)}
            for path, _, _ in per_file}
    for path, n_lvl, locs in per_file:
        for n in range(1, n_lvl + 1):
            seen = {tuple(v) for v in merged_locs[n]}
            for b in range(locs[n].shape[0]):
                loc = tuple(locs[n][b])
                if loc not in seen:
                    take[path][n].append(b)
                    merged_locs[n].append(list(loc))
                    seen.add(loc)

    data["adaptive_num_levels"] = np.array([num_levels], dtype=np.int32)
    if any_adaptive:
        root_blocks = None
        with np.load(inputs[0]) as f:
            if "adaptive_num_blocks" in f.files:
                root_blocks = int(f["adaptive_num_blocks"][0])
        counts = [root_blocks or 0] + [len(merged_locs[n])
                                       for n in range(1, num_levels + 1)]
        data["adaptive_num_blocks"] = np.array(counts, dtype=np.int32)
        for n in range(1, num_levels + 1):
            data[f"adaptive_block_locs_{n}"] = np.array(merged_locs[n],
                                                        dtype=np.int32)

    for n in range(1, num_levels + 1):
        pieces = {name: [] for name in names_present}
        for path, n_lvl, _ in per_file:
            if n > n_lvl or not take[path][n]:
                continue
            with np.load(path) as f:
                for name in names_present:
                    key = f"adaptive_{name}_{n}"
                    if key not in f.files:
                        continue
                    arr = np.asarray(f[key])
                    ax = _block_axis(name, multifreq)
                    pieces[name].append(np.take(arr, take[path][n], axis=ax))
        for name in names_present:
            if pieces[name]:
                ax = _block_axis(name, multifreq)
                data[f"adaptive_{name}_{n}"] = np.concatenate(pieces[name],
                                                              axis=ax)
    return data


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-i", "--inputs", nargs="+", required=True)
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("-n", "--names", nargs="+", default=None)
    args = parser.parse_args()
    if args.output[-4:] != ".npz":
        raise RuntimeError("Only npz format supported.")
    data = join(args.inputs, args.names)
    np.savez(args.output, **data)


if __name__ == "__main__":
    main()
