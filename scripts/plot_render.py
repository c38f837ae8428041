#!/usr/bin/env python
"""Plot a false-color volume rendering from a blacklight npz output.

Capability parity with the reference's plot_render.py (206 lines): converts
the stored CIE XYZ rendering to sRGB with optional exposure scaling and
writes an image file.
"""

from __future__ import annotations

import argparse

import numpy as np


def xyz_to_srgb(xyz):
    """CIE XYZ (D65) -> sRGB with gamma, clipped to [0, 1]."""
    m = np.array([[3.2406, -1.5372, -0.4986],
                  [-0.9689, 1.8758, 0.0415],
                  [0.0557, -0.2040, 1.0570]])
    rgb = np.einsum("ij,...j->...i", m, xyz)
    rgb = np.clip(rgb, 0.0, None)
    srgb = np.where(rgb <= 0.0031308, 12.92 * rgb,
                    1.055 * rgb ** (1.0 / 2.4) - 0.055)
    return np.clip(srgb, 0.0, 1.0)


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("filename_data")
    parser.add_argument("filename_plot")
    parser.add_argument("-i", "--image_num", type=int, default=1,
                        help="1-indexed rendering to plot")
    parser.add_argument("--exposure", type=float, default=1.0)
    parser.add_argument("--dpi", type=int, default=150)
    args = parser.parse_args()

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with np.load(args.filename_data) as f:
        rendering = np.asarray(f["rendering"])   # (n_img, 3, res, res)
        half = float(f["width"][0]) / 2.0
    xyz = np.moveaxis(rendering[args.image_num - 1], 0, -1)  # (res, res, 3)
    rgb = xyz_to_srgb(xyz * args.exposure)

    fig, ax = plt.subplots(figsize=(5.5, 5.5))
    ax.imshow(rgb, origin="lower", extent=(-half, half, -half, half))
    ax.set_xlabel(r"$x$ ($GM/c^2$)")
    ax.set_ylabel(r"$y$ ($GM/c^2$)")
    fig.savefig(args.filename_plot, dpi=args.dpi, bbox_inches="tight")


if __name__ == "__main__":
    main()
