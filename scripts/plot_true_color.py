#!/usr/bin/env python
"""True-color plot of a multi-frequency blacklight output.

Capability parity with the reference's plot_true_color.py (491 lines): the
image frequencies are mapped (linearly in wavelength) onto the visible
band, each frequency's I_nu is weighted by the CIE 1931 color-matching
functions, and the integrated XYZ is converted to sRGB.

The CMFs use the multi-lobe Gaussian fits of Wyman, Sloan & Shirley (2013,
JCGT 2-2), accurate to ~1% - a standalone closed form instead of the
reference's embedded lookup table.
"""

from __future__ import annotations

import argparse

import numpy as np


def _g(x, mu, s1, s2):
    s = np.where(x < mu, s1, s2)
    return np.exp(-0.5 * ((x - mu) / s) ** 2)


def cie_xyz_cmf(lambda_nm):
    """Approximate CIE 1931 2-degree color-matching functions."""
    x = (1.056 * _g(lambda_nm, 599.8, 37.9, 31.0)
         + 0.362 * _g(lambda_nm, 442.0, 16.0, 26.7)
         - 0.065 * _g(lambda_nm, 501.1, 20.4, 26.2))
    y = (0.821 * _g(lambda_nm, 568.8, 46.9, 40.5)
         + 0.286 * _g(lambda_nm, 530.9, 16.3, 31.1))
    z = (1.217 * _g(lambda_nm, 437.0, 11.8, 36.0)
         + 0.681 * _g(lambda_nm, 459.0, 26.0, 13.8))
    return x, y, z


def true_color_rgb(frequencies, i_nu, exposure=1.0):
    """(F,) frequencies + (F, res, res) images -> (res, res, 3) sRGB.

    Frequencies map to visible wavelengths linearly in wavelength: the
    longest wavelength (lowest frequency) lands at 700 nm, the shortest at
    400 nm; integration over the band uses trapezoid weights.
    """
    from plot_render import xyz_to_srgb

    frequencies = np.asarray(frequencies, dtype=float)
    order = np.argsort(frequencies)
    frequencies = frequencies[order]
    i_nu = np.asarray(i_nu, dtype=float)[order]
    wave = 1.0 / frequencies
    frac = (wave - wave.min()) / max(wave.max() - wave.min(), 1e-300)
    # frac = 1 at the longest wavelength -> 700 nm; frac = 0 -> 400 nm
    lambda_nm = 400.0 + 300.0 * frac
    xbar, ybar, zbar = cie_xyz_cmf(lambda_nm)
    w = np.gradient(lambda_nm)
    w = np.abs(w)
    xyz = np.stack([
        np.tensordot(xbar * w, i_nu, axes=1),
        np.tensordot(ybar * w, i_nu, axes=1),
        np.tensordot(zbar * w, i_nu, axes=1)], axis=-1)
    norm = np.nanmax(xyz[..., 1]) or 1.0
    return xyz_to_srgb(xyz / norm * exposure)


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("filename_data")
    parser.add_argument("filename_plot")
    parser.add_argument("--exposure", type=float, default=1.0)
    parser.add_argument("--dpi", type=int, default=150)
    args = parser.parse_args()

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with np.load(args.filename_data) as f:
        frequencies = np.asarray(f["frequency"])
        i_nu = np.asarray(f["I_nu"])
        half = float(f["width"][0]) / 2.0
    if i_nu.ndim != 3 or len(frequencies) < 2:
        raise RuntimeError("True color requires a multi-frequency output.")
    rgb = true_color_rgb(frequencies, np.nan_to_num(i_nu),
                         exposure=args.exposure)

    fig, ax = plt.subplots(figsize=(5.5, 5.5))
    ax.imshow(rgb, origin="lower", extent=(-half, half, -half, half))
    ax.set_xlabel(r"$x$ ($GM/c^2$)")
    ax.set_ylabel(r"$y$ ($GM/c^2$)")
    fig.savefig(args.filename_plot, dpi=args.dpi, bbox_inches="tight")


if __name__ == "__main__":
    main()
