#!/usr/bin/env python
"""Total flux (Jy) from a blacklight output file.

Capability parity with the reference's calculate_flux.py (238 lines): sums
I_nu over the image plane, converting specific intensity to flux density
via the per-pixel solid angle, honoring adaptive refinement by counting
each region of the image plane at its finest rendered level.
"""

from __future__ import annotations

import argparse

import numpy as np

C = 2.99792458e10
GG_MSUN = 1.32712440018e26
PC = 9.69394202136e18 / np.pi
JY = 1.0e-23


def flux_jy(data: dict, distance_pc: float, frequency_num: int = 1,
            stokes: str = "I") -> float:
    """Flux density in Jy at one frequency.

    Adaptive handling: a root (or level-l) block covered by level-(l+1)
    children is excluded; its children are counted instead, each pixel
    carrying 1/4 the parent pixel's solid angle.
    """
    mass_msun = float(data["mass_msun"][0])
    width = float(data["width"][0])
    num_freq = len(data["frequency"])
    key = f"{stokes}_nu"
    img = np.asarray(data[key])
    if num_freq > 1:
        img = img[frequency_num - 1]
    res = img.shape[-1]

    rg = GG_MSUN * mass_msun / C ** 2
    d_cgs = distance_pc * PC
    omega_pix0 = (width * rg / (res * d_cgs)) ** 2

    num_levels = int(data["adaptive_num_levels"][0]) \
        if "adaptive_num_levels" in data else 0
    if num_levels == 0:
        return float(np.nansum(img) * omega_pix0 / JY)

    total = 0.0
    # Root level: skip blocks that level 1 refines
    locs_next = np.asarray(data["adaptive_block_locs_1"])
    parents = {tuple(p) for p in (locs_next // 2).tolist()}
    bs = np.asarray(data[f"adaptive_{key}_1"]).shape[-1]
    linear = res // bs
    img2 = img.reshape(res, res)
    for v in range(linear):
        for u in range(linear):
            if (v, u) in parents:
                continue
            total += np.nansum(img2[v * bs:(v + 1) * bs, u * bs:(u + 1) * bs]) \
                * omega_pix0
    # refined levels
    for n in range(1, num_levels + 1):
        locs = np.asarray(data[f"adaptive_block_locs_{n}"])
        arr = np.asarray(data[f"adaptive_{key}_{n}"])
        if num_freq > 1:
            arr = arr[frequency_num - 1]
        omega = omega_pix0 / 4.0 ** n
        if n < num_levels:
            locs_next = np.asarray(data[f"adaptive_block_locs_{n + 1}"])
            parents = {tuple(p) for p in (locs_next // 2).tolist()}
        else:
            parents = set()
        for b in range(locs.shape[0]):
            if tuple(locs[b]) in parents:
                continue
            total += np.nansum(arr[b]) * omega
    return float(total / JY)


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("filename_data", help="npz output file")
    parser.add_argument("-d", "--distance", type=float, required=True,
                        help="distance to source in parsecs")
    parser.add_argument("--frequency_num", type=int, default=1,
                        help="1-indexed frequency to use")
    parser.add_argument("--stokes", default="I",
                        choices=("I", "Q", "U", "V"))
    args = parser.parse_args()
    with np.load(args.filename_data) as f:
        data = {k: f[k] for k in f.files}
    print(flux_jy(data, args.distance, args.frequency_num, args.stokes))


if __name__ == "__main__":
    main()
