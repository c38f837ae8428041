"""AthenaK binary snapshot loader (host side, NumPy).

Covers the reference's AthenaK branch: text header with version/time/sizes/
variable names/header offset (src/simulation_reader/simulation_reader.cpp:
915-1014 ReadAthenaKHeader), <parameter-section> key=value inputs
(:1027-1139 ReadAthenaKInputs), per-block records of
  [24B ijk index range][12B logical location][4B level]
  [6 * location_size face coords][n_vars * cells * variable_size cell data]
(:433-588), variable layout dens/velx/vely/velz/eint/bcc1-3 (:1226-1294),
and the eint -> pgas conversion (:581-587). Cell data are CKS; no
coordinate conversion applies.
"""

from __future__ import annotations

import io
import re

import jax.numpy as jnp
import numpy as np

from blacklight.utils.errors import BlacklightError, blacklight_warning


def _header_int(line: bytes, prefix: str):
    text = line.decode(errors="replace")
    if not text.startswith(prefix):
        raise BlacklightError("Invalid AthenaK file header.")
    return text[len(prefix):].strip()


def load_athenak(path: str, kappa_name=None, dtype=jnp.float64,
                 plasma_gamma=None, expected=None):
    """Load an AthenaK binary dump.

    expected: optional dict of user inputs to check against the file's
    parameter section: a, bhmass_msun, density_cgs, mu (warnings on
    mismatch, reference :1057-1124).
    """
    from blacklight.grid.athena import SimulationGrid

    with open(path, "rb") as f:
        data = f.read()
    stream = io.BytesIO(data)

    line = stream.readline().rstrip(b"\n")
    if line != b"Athena binary output version=1.1":
        raise BlacklightError("Unknown AthenaK file format.")
    stream.readline()  # unchecked preamble line (preheader size) (:932-934)
    time = float(_header_int(stream.readline().rstrip(b"\n"), "  time="))
    stream.readline()  # unchecked line (cycle) before location size (:943-945)
    loc_size = int(_header_int(stream.readline().rstrip(b"\n"),
                               "  size of location="))
    var_size = int(_header_int(stream.readline().rstrip(b"\n"),
                               "  size of variable="))
    if loc_size not in (4, 8):
        raise BlacklightError("Unsupported size of location.")
    if var_size not in (4, 8):
        raise BlacklightError("Unsupported size of variables.")
    n_vars = int(_header_int(stream.readline().rstrip(b"\n"),
                             "  number of variables="))
    names_line = stream.readline().rstrip(b"\n").decode(errors="replace")
    if not names_line.startswith("  variables:"):
        raise BlacklightError("Invalid AthenaK file header.")
    variable_names = names_line[len("  variables:"):].split()
    if len(variable_names) != n_vars:
        raise BlacklightError("Invalid AthenaK file header.")
    header_offset = int(_header_int(stream.readline().rstrip(b"\n"),
                                    "  header offset="))
    param_start = stream.tell()
    data_offset = param_start + header_offset

    # Parameter section (ReadAthenaKInputs)
    params = {}
    section = ""
    for raw in data[param_start:data_offset].split(b"\n"):
        text = raw.decode(errors="replace").strip()
        if not text or text.startswith("#"):
            continue
        if text.startswith("<") and text.endswith(">"):
            section = text[1:-1]
            continue
        if "=" in text:
            key, _, value = text.partition("=")
            params[(section, key.strip())] = value.split("#")[0].strip()
    gamma = plasma_gamma
    if ("mhd", "gamma") in params:
        file_gamma = float(params[("mhd", "gamma")])
        if gamma is None:
            gamma = file_gamma
        elif gamma != file_gamma:
            blacklight_warning(
                f"Given total adiabatic index of {gamma} does not match file "
                f"value of {file_gamma}; ignoring the latter.")
    if gamma is None:
        raise BlacklightError("Missing adiabatic index.")
    for (sec, key), label in ((("coord", "a"), "spin"),
                              (("units", "bhmass_msun"), "mass"),
                              (("units", "density_cgs"), "density scale"),
                              (("units", "mu"), "molecular weight")):
        if expected and key in expected and (sec, key) in params:
            file_val = float(params[(sec, key)])
            if file_val != expected[key]:
                blacklight_warning(
                    f"Given {label} of {expected[key]} does not match file "
                    f"value of {file_val}; ignoring the latter.")

    # Variable layout (VerifyVariablesAthenaK, :1226-1294)
    wanted = {"rho": "dens", "uu1": "velx", "uu2": "vely", "uu3": "velz",
              "pgas": "eint", "bb1": "bcc1", "bb2": "bcc2", "bb3": "bcc3"}
    if kappa_name is not None:
        wanted["kappa"] = kappa_name
    file_ind = {}
    for key, var in wanted.items():
        if var not in variable_names:
            raise BlacklightError(
                f'Unable to locate "{var}" values in data file.')
        file_ind[key] = variable_names.index(var)

    # Block geometry from the first block's index range (:433-448)
    idx = np.frombuffer(data, dtype=np.int32, count=6, offset=data_offset)
    nx = int(idx[1] - idx[0] + 1)
    ny = int(idx[3] - idx[2] + 1)
    nz = int(idx[5] - idx[4] + 1)
    cells = nx * ny * nz
    block_bytes = 24 + 16 + 6 * loc_size + n_vars * cells * var_size
    n_blocks = (len(data) - data_offset) // block_bytes
    if n_blocks < 1 or (len(data) - data_offset) % block_bytes != 0:
        raise BlacklightError("Unknown AthenaK file format.")

    loc_dtype = np.float32 if loc_size == 4 else np.float64
    var_dtype = np.float32 if var_size == 4 else np.float64

    levels = np.empty(n_blocks, dtype=np.int32)
    locations = np.empty((n_blocks, 3), dtype=np.int32)
    faces = np.empty((n_blocks, 6), dtype=np.float64)
    cell_data = np.empty((n_blocks, n_vars, nz, ny, nx), dtype=np.float32)

    for b in range(n_blocks):
        off = data_offset + b * block_bytes
        locations[b] = np.frombuffer(data, np.int32, 3, off + 24)
        levels[b] = np.frombuffer(data, np.int32, 1, off + 36)[0]
        faces[b] = np.frombuffer(data, loc_dtype, 6, off + 40)
        cell_off = off + 40 + 6 * loc_size
        block = np.frombuffer(data, var_dtype, n_vars * cells, cell_off)
        cell_data[b] = block.reshape(n_vars, nz, ny, nx)

    # Uniform per-block faces/centers (:496-529)
    def expand(lo, hi, n):
        # (n_blocks,) bounds -> faces (n_blocks, n+1), centers (n_blocks, n)
        frac = np.arange(n + 1, dtype=np.float64) / n
        xf = lo[:, None] + (hi - lo)[:, None] * frac[None, :]
        xf[:, 0] = lo
        xf[:, -1] = hi
        return xf, 0.5 * (xf[:, :-1] + xf[:, 1:])

    x1f, x1v = expand(faces[:, 0], faces[:, 1], nx)
    x2f, x2v = expand(faces[:, 2], faces[:, 3], ny)
    x3f, x3v = expand(faces[:, 4], faces[:, 5], nz)

    # Repack to internal order rho,uu1,uu2,uu3,pgas,bb1,bb2,bb3[,kappa]
    # (:538-541, 575-579) and convert eint -> pgas (:581-587)
    order = ["rho", "uu1", "uu2", "uu3", "pgas", "bb1", "bb2", "bb3"]
    if kappa_name is not None:
        order.append("kappa")
    prim = np.ascontiguousarray(
        cell_data[:, [file_ind[k] for k in order]].transpose(1, 0, 2, 3, 4))
    ind = {name: slot for slot, name in enumerate(order)}
    from blacklight import native
    native.scale_slice(prim, ind["pgas"], gamma - 1.0)

    # AMR metadata for exact interblock sampling (grid/amr.py). CKS grids
    # have no periodic phi, so n3_root stays unused (FindNearbyInds'
    # periodic branch is SKS-only, simulation_sampling.cpp:1183-1211).
    return SimulationGrid(
        prim=jnp.asarray(prim),
        x1f=jnp.asarray(x1f, dtype=dtype), x1v=jnp.asarray(x1v, dtype=dtype),
        x2f=jnp.asarray(x2f, dtype=dtype), x2v=jnp.asarray(x2v, dtype=dtype),
        x3f=jnp.asarray(x3f, dtype=dtype), x3v=jnp.asarray(x3v, dtype=dtype),
        ind=ind, time=time, coords="cks",
        levels=levels, locations=locations.astype(np.int64))
