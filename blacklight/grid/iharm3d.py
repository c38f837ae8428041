"""iharm3d HDF5 snapshot loader (host side, h5py).

Covers what the reference reads from iharm-family dumps
(src/simulation_reader/simulation_reader.cpp:345-431 metric params,
:622-660 uniform-grid reconstruction, :782-807 transpose + internal-energy
-> pressure, and VerifyVariablesHarm :1302-1424), followed by the
coordinate and primitive conversions of simulation_geometry.cpp. Supports
simulation_coord = sks (metric MKS: grid coordinates transformed to SKS at
load) and fmks (MMKS/FMKS: grid stays native; an inverse SKS->FMKS lookup
table is attached for the device sampler).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from blacklight.constants import Coordinates, PlasmaModel
from blacklight.grid import mks
from blacklight.grid.athena import SimulationGrid, import_h5py
from blacklight.utils.errors import BlacklightError, blacklight_warning


def _scalar(f, name):
    return np.asarray(f[name]).reshape(-1)[0]


def _faces_centers(start, dx, n):
    xf = start + dx * np.arange(n + 1, dtype=np.float64)
    xv = 0.5 * (xf[:-1] + xf[1:])
    return xf, xv


def load_iharm3d(path: str, cfg, dtype=jnp.float64) -> SimulationGrid:
    """Load an iharm3d dump; cfg supplies simulation_* / plasma_* options."""
    h5py = import_h5py()

    coord = cfg.require("simulation_coord")
    if coord not in (Coordinates.sks, Coordinates.fmks):
        raise BlacklightError("Invalid simulation_coord for Harm format.")
    spin = cfg.require("simulation_a")
    plasma_model = cfg.require("plasma_model")
    kappa_name = cfg.require("simulation_kappa_name") \
        if plasma_model == PlasmaModel.code_kappa else None

    with h5py.File(path, "r") as f:
        time = float(_scalar(f, "t"))

        # Metric parameters (simulation_reader.cpp:364-431)
        metric = np.asarray(f["header/metric"]).reshape(-1)[0]
        if isinstance(metric, bytes):
            metric = metric.decode()
        if metric not in ("MKS", "MMKS", "FMKS"):
            blacklight_warning(
                f"Given metric mks does not match file value of {metric}; "
                "ignoring the latter.")
        metric_lower = metric.lower()
        geom = f"header/geom/{metric_lower}"
        metric_a = float(_scalar(f, f"{geom}/a"))
        if metric_a != spin:
            blacklight_warning(
                f"Given spin of {spin} does not match file value of {metric_a}; "
                "ignoring the latter.")
        hslope = float(_scalar(f, f"{geom}/hslope"))
        fmks_params = None
        if metric in ("MMKS", "FMKS"):
            r_in = None
            for key in ("r_in", "Rin"):
                if f"{geom}/{key}" in f:
                    r_in = float(_scalar(f, f"{geom}/{key}"))
                    break
            if r_in is None:
                raise BlacklightError(
                    "Unable to identify r_in parameter for iharm3d-format file.")
            fmks_params = mks.FmksParams(
                h=hslope, r_in=r_in,
                poly_xt=float(_scalar(f, f"{geom}/poly_xt")),
                poly_alpha=float(_scalar(f, f"{geom}/poly_alpha")),
                mks_smooth=float(_scalar(f, f"{geom}/mks_smooth")))

        # Uniform native-coordinate grid (simulation_reader.cpp:622-660)
        n1 = int(_scalar(f, "header/n1"))
        n2 = int(_scalar(f, "header/n2"))
        n3 = int(_scalar(f, "header/n3"))
        x1f, x1v = _faces_centers(float(_scalar(f, "header/geom/startx1")),
                                  float(_scalar(f, "header/geom/dx1")), n1)
        x2f, x2v = _faces_centers(float(_scalar(f, "header/geom/startx2")),
                                  float(_scalar(f, "header/geom/dx2")), n2)
        x3f, x3v = _faces_centers(float(_scalar(f, "header/geom/startx3")),
                                  float(_scalar(f, "header/geom/dx3")), n3)

        # Variable layout (VerifyVariablesHarm, simulation_reader.cpp:1302-1424)
        prim_names = [n.decode() if isinstance(n, bytes) else str(n)
                      for n in np.asarray(f["header/prim_names"]).reshape(-1)]
        wanted = {"rho": "RHO", "pgas": "UU", "uu1": "U1", "uu2": "U2",
                  "uu3": "U3", "bb1": "B1", "bb2": "B2", "bb3": "B3"}
        if kappa_name is not None:
            wanted["kappa"] = kappa_name
        ind = {}
        for key, var in wanted.items():
            if var not in prim_names:
                raise BlacklightError(
                    f'Unable to locate "{var}" slice of "prims" in data file.')
            ind[key] = prim_names.index(var)

        # Adiabatic indices, preferring user input (simulation_reader.cpp:1372-1423)
        gamma = cfg.plasma_gamma
        if "header/gam" in f:
            file_gam = float(_scalar(f, "header/gam"))
            if gamma is None:
                gamma = file_gam
            elif gamma != file_gam:
                blacklight_warning(
                    f"Given total adiabatic index of {gamma} does not match "
                    f"file value of {file_gam}; ignoring the latter.")
        elif gamma is None:
            raise BlacklightError(
                "Could not find total adiabatic index in input or data file.")

        # Cell data: file layout (n1, n2, n3, nvar) -> (nvar, 1, n3, n2, n1)
        prims = np.asarray(f["prims"], dtype=np.float32)

    from blacklight import native
    prim = native.repack_table(prims, 0, prims.shape[-1])[:, None]
    native.scale_slice(prim, ind["pgas"], gamma - 1.0)

    warn = blacklight_warning
    sks_map = None
    map_r_in = map_dr = map_dtheta = 0.0
    bounds = None
    if coord == Coordinates.fmks:
        # Grid stays native; build inverse lookup (simulation_geometry.cpp:38-59)
        r_in_map = float(np.exp(x1f[0]))
        r_out_map = float(np.exp(x1f[-1]))
        table, dr, dtheta = mks.generate_sks_map(fmks_params, r_in_map, r_out_map)
        sks_map = table
        map_r_in, map_dr, map_dtheta = r_in_map, dr, dtheta
        r_lo, th_lo = mks.fmks_sks_coords(x1f[0], 0.0, fmks_params)
        r_hi, th_hi = mks.fmks_sks_coords(x1f[-1], 1.0, fmks_params)
        # phi bounds are literal [0, 2*pi]: the reference always passes 0
        # and 2*pi to GetSKSCoordinates (simulation_geometry.cpp:47-58),
        # independent of the file's raw phi faces (which snap_angular_domain
        # may later adjust).
        bounds = (float(r_lo), float(r_hi), float(th_lo), float(th_hi),
                  0.0, 2.0 * np.pi)
        r_v, th_v = mks.fmks_sks_coords(
            x1v[None, None, :], x2v[None, :, None], fmks_params)
        mks.convert_primitives_3(prim, ind, x1v, x2v, x3v, r_v, th_v, spin,
                                 "fmks", fmks_params)
        x1f_out, x1v_out, x2f_out, x2v_out = x1f, x1v, x2f, x2v
    else:
        # MKS: transform grid coordinates to SKS (simulation_geometry.cpp:62-82)
        x2v_alt = x2v.copy()
        x1f_out, x1v_out = np.exp(x1f), np.exp(x1v)
        x2f_out = mks.mks_theta(x2f, hslope)
        x2v_out = mks.mks_theta(x2v, hslope)
        mks.snap_angular_domain(x2f_out, x3f, warn)
        mks.convert_primitives_3(prim, ind, np.log(x1v_out), x2v_alt, x3v,
                                 x1v_out, x2v_out, spin, "mks", hslope)

    if coord == Coordinates.fmks:
        mks.snap_angular_domain(x2f, x3f, warn, snap_theta=False)

    return SimulationGrid(
        prim=jnp.asarray(prim),
        x1f=jnp.asarray(x1f_out[None, :], dtype=dtype),
        x1v=jnp.asarray(x1v_out[None, :], dtype=dtype),
        x2f=jnp.asarray(x2f_out[None, :], dtype=dtype),
        x2v=jnp.asarray(x2v_out[None, :], dtype=dtype),
        x3f=jnp.asarray(x3f[None, :], dtype=dtype),
        x3v=jnp.asarray(x3v[None, :], dtype=dtype),
        ind=ind, time=time,
        sks_map=None if sks_map is None else jnp.asarray(sks_map, dtype=dtype),
        map_r_in=map_r_in, map_dr=map_dr, map_dtheta=map_dtheta,
        bounds=bounds)
