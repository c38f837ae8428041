"""harm3d ASCII+binary snapshot loader (host side, NumPy).

Covers the reference's harm3d branch (src/simulation_reader/
simulation_reader.cpp:661-718 header + uniform MKS grid, :808-850 binary
cell block): a whitespace ASCII header
  time n1 n2 n3 startx1 startx2 startx3 dx1 dx2 dx3 a gamma <r_in> hslope <n>
followed by one separator byte and float32 cell data laid out
(i, j, k, 6 coordinate columns + rho, ugas, u^0..u^3, b^0..b^3 [, kappa]).
Primitives are 4-vectors in the coordinate frame of modified (MKS)
coordinates; conversion to the SKS normal frame follows
simulation_geometry.cpp:242-317.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from blacklight.constants import Coordinates, PlasmaModel
from blacklight.grid import mks
from blacklight.grid.athena import SimulationGrid
from blacklight.utils.errors import BlacklightError, blacklight_warning


def load_harm3d(path: str, cfg, dtype=jnp.float64) -> SimulationGrid:
    """Load a harm3d snapshot; cfg supplies simulation_*/plasma_* options."""
    coord = cfg.require("simulation_coord")
    if coord != Coordinates.sks:
        raise BlacklightError("Invalid simulation_coord for Harm format.")
    spin = cfg.require("simulation_a")
    plasma_model = cfg.require("plasma_model")
    has_kappa = plasma_model == PlasmaModel.code_kappa

    with open(path, "rb") as f:
        # ASCII header: 15 whitespace-separated tokens
        # (simulation_reader.cpp:664-716)
        tokens = []
        while len(tokens) < 15:
            tok = b""
            c = f.read(1)
            while c in b" \t\r\n" and c:
                c = f.read(1)
            while c not in b" \t\r\n" and c:
                tok += c
                c = f.read(1)
            if not tok:
                raise BlacklightError("Could not parse harm3d header.")
            tokens.append(tok)
        # The reference then skips exactly one byte past the last token's
        # trailing separator (already consumed above).
        data_start = f.tell()

        time = float(tokens[0])
        n1, n2, n3 = int(tokens[1]), int(tokens[2]), int(tokens[3])
        startx = [float(t) for t in tokens[4:7]]
        dx = [float(t) for t in tokens[7:10]]
        metric_a = float(tokens[10])
        file_gamma = float(tokens[11])
        hslope = float(tokens[13])

        if metric_a != spin:
            blacklight_warning(
                f"Given spin of {spin} does not match file value of {metric_a}; "
                "ignoring the latter.")
        gamma = cfg.plasma_gamma
        if gamma is None:
            gamma = file_gamma
        elif gamma != file_gamma:
            blacklight_warning(
                f"Given total adiabatic index of {gamma} does not match file "
                f"value of {file_gamma}; ignoring the latter.")

        n_var = 11 if has_kappa else 10
        n_cols = n_var + 6
        f.seek(data_start)
        raw = np.fromfile(f, dtype=np.float32, count=n1 * n2 * n3 * n_cols)
    if raw.size != n1 * n2 * n3 * n_cols:
        raise BlacklightError("harm3d file truncated.")
    # File layout (i, j, k, col); internal layout (var, block, k, j, i)
    from blacklight import native
    table = raw.reshape(n1, n2, n3, n_cols)
    prim = native.repack_table(table, 6, n_var)[:, None]

    ind = {"rho": 0, "pgas": 1, "u0": 2, "uu1": 3, "uu2": 4, "uu3": 5,
           "b0": 6, "bb1": 7, "bb2": 8, "bb3": 9}
    if has_kappa:
        ind["kappa"] = 10
    native.scale_slice(prim, ind["pgas"], gamma - 1.0)

    def faces_centers(start, d, n):
        xf = start + d * np.arange(n + 1, dtype=np.float64)
        return xf, 0.5 * (xf[:-1] + xf[1:])

    x1f, x1v = faces_centers(startx[0], dx[0], n1)
    x2f, x2v = faces_centers(startx[1], dx[1], n2)
    x3f, x3v = faces_centers(startx[2], dx[2], n3)

    # MKS -> SKS grid coordinates (simulation_geometry.cpp:62-82)
    x2v_alt = x2v.copy()
    x1f_sks, x1v_sks = np.exp(x1f), np.exp(x1v)
    x2f_sks = mks.mks_theta(x2f, hslope)
    x2v_sks = mks.mks_theta(x2v, hslope)
    mks.snap_angular_domain(x2f_sks, x3f, blacklight_warning)

    mks.convert_primitives_4(prim, ind, x2v_alt, x1v_sks, x2v_sks, spin, hslope)

    return SimulationGrid(
        prim=jnp.asarray(prim),
        x1f=jnp.asarray(x1f_sks[None, :], dtype=dtype),
        x1v=jnp.asarray(x1v_sks[None, :], dtype=dtype),
        x2f=jnp.asarray(x2f_sks[None, :], dtype=dtype),
        x2v=jnp.asarray(x2v_sks[None, :], dtype=dtype),
        x3f=jnp.asarray(x3f[None, :], dtype=dtype),
        x3v=jnp.asarray(x3v[None, :], dtype=dtype),
        ind=ind, time=time)
