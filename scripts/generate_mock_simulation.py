#!/usr/bin/env python
"""Generate synthetic GRMHD snapshots for testing every reader path.

Capability parity with the reference's mock generator
(reference scripts/generate_mock_simulation.py, 431 lines): an analytic
torus-like disk (power-law rho/pgas/u^phi with exponential theta-profiles,
vertical+toroidal B, optional multiplicative perturbations) written in any
of the four supported formats - plus AthenaK, which the reference's
generator cannot emit:

  athena   - Athena++ .athdf (HDF5): SKS grid, normal-frame 3-velocity
  athenak  - AthenaK binary v1.1: uniform CKS Cartesian blocks
  iharm3d  - iharm HDF5: MKS (or FMKS) grid, modified normal-frame velocity
  harm3d   - ASCII header + float32 binary: MKS grid, coordinate-frame
             4-vectors

All fields are generated at spin a=0 (as the reference's mock does), so the
same physical disk is representable exactly in every coordinate system and
cross-format reader tests can demand close agreement.
"""

from __future__ import annotations

import argparse

import numpy as np


DEFAULTS = dict(
    n_r=32, n_th=16, n_ph=8, r_min=2.0, r_max=30.0,
    cutoff_r_min=4.0, cutoff_r_max=20.0, cutoff_th_min=0.3,
    rho_amp=1.0, rho_r_power=1.5, rho_th_scale=0.3, rho_floor=1.0e-8,
    pgas_amp=0.1, pgas_r_power=2.5, pgas_th_scale=0.3, pgas_floor=1.0e-10,
    uph_amp=0.3, uph_r_power=1.5, uph_th_scale=0.5,
    bz_amp=0.1, bz_r_power=1.0,
    bph_amp=0.05, bph_r_power=1.5, bph_th_scale=0.5, bph_no_flip=False,
    pert_amp=0.0, pert_n_r=4, pert_n_th=2, pert_n_ph=2,
    gamma_adi=13.0 / 9.0, hslope=1.0, time=0.0,
)


def eval_fields(p, r, th, ph):
    """Analytic torus fields at arbitrary 1-D center arrays.

    Returns dict of (len(ph), len(th), len(r)) cell fields - the same
    formulas as make_fields, usable per mesh block (AMR writer).
    """
    R = r[None, None, :]
    TH = th[None, :, None]
    PH = ph[:, None, None]

    keep = ((R >= p["cutoff_r_min"]) & (R <= p["cutoff_r_max"])
            & (TH >= p["cutoff_th_min"]) & (TH <= np.pi - p["cutoff_th_min"]))
    cutoff = keep.astype(float) * np.ones_like(PH)

    pert = np.ones((len(ph), len(th), len(r)))
    if p["pert_amp"] != 0.0:
        pr = np.cos(2.0 * np.pi * p["pert_n_r"]
                    * np.log(R / p["cutoff_r_min"])
                    / np.log(p["cutoff_r_max"] / p["cutoff_r_min"]))
        pt = -np.cos(2.0 * np.pi * p["pert_n_th"] * (TH - p["cutoff_th_min"])
                     / (np.pi - 2.0 * p["cutoff_th_min"]))
        pp = np.cos(p["pert_n_ph"] * PH)
        pert = 1.0 + p["pert_amp"] * pr * pt * pp

    zdist = np.abs(TH - np.pi / 2.0)
    rho = np.maximum(p["rho_amp"] * R ** -p["rho_r_power"]
                     * np.exp(-zdist / p["rho_th_scale"]) * pert * cutoff,
                     p["rho_floor"])
    pgas = np.maximum(p["pgas_amp"] * R ** -p["pgas_r_power"]
                      * np.exp(-zdist / p["pgas_th_scale"]) * pert ** 2 * cutoff,
                      p["pgas_floor"])
    uur = np.zeros_like(rho)
    uuth = np.zeros_like(rho)
    uuph = (p["uph_amp"] * R ** -p["uph_r_power"]
            * np.exp(-zdist / p["uph_th_scale"]) * cutoff)
    rcyl = np.maximum(R * np.sin(TH), p["cutoff_r_min"])
    bbz = p["bz_amp"] * rcyl ** -p["bz_r_power"]
    bbr = np.cos(TH) * bbz * np.ones_like(PH)
    bbth = -np.sin(TH) / R * bbz * np.ones_like(PH)
    bbph = (p["bph_amp"] * R ** -p["bph_r_power"]
            * np.exp(-zdist / p["bph_th_scale"]) * np.ones_like(PH))
    if not p["bph_no_flip"]:
        bbph = bbph * np.where(TH > np.pi / 2.0, -1.0, 1.0)

    return dict(rho=rho, pgas=pgas, uur=uur, uuth=uuth, uuph=uuph,
                bbr=bbr, bbth=bbth, bbph=bbph)


def make_fields(p, thf=None, thv=None):
    """Analytic torus on a log-r x theta x uniform-phi SKS grid.

    thf/thv optionally override the default uniform theta faces/centers
    (e.g. with FMKS collocation points for exact cross-format tests).

    Returns dict with grid arrays and (n_ph, n_th, n_r) cell fields:
    rho, pgas, uur/uuth/uuph (SKS normal frame), bbr/bbth/bbph (SKS
    cell-frame field).
    """
    lrf = np.linspace(np.log(p["r_min"]), np.log(p["r_max"]), p["n_r"] + 1)
    rf = np.exp(lrf)
    if thf is None:
        thf = np.linspace(0.0, np.pi, p["n_th"] + 1)
    phf = np.linspace(0.0, 2.0 * np.pi, p["n_ph"] + 1)
    # Geometric-mean radial centers: iharm3d/harm3d readers reconstruct
    # centers as midpoints in native x^1 = log r, so evaluating fields there
    # makes every format represent the identical physical snapshot.
    r = np.exp(0.5 * (lrf[:-1] + lrf[1:]))
    th = 0.5 * (thf[:-1] + thf[1:]) if thv is None else np.asarray(thv)
    ph = 0.5 * (phf[:-1] + phf[1:])

    out = dict(lrf=lrf, rf=rf, thf=thf, phf=phf, r=r, th=th, ph=ph)
    out.update(eval_fields(p, r, th, ph))
    return out


def _sks_frames(fields, p):
    """SKS normal-frame (uu) -> coordinate-frame u^mu and b^mu, at a=0.

    Schwarzschild Kerr-Schild: g_tt=-(1-f), g_tr=f, g_rr=1+f, g_thth=r^2,
    g_phph=r^2 sin^2, g^tt=-(1+f), g^tr=f with f=2/r.
    """
    R = fields["r"][None, None, :]
    TH = fields["th"][None, :, None]
    f = 2.0 / R
    g_tt, g_tr, g_rr = -(1.0 - f), f, 1.0 + f
    g_thth = R ** 2
    g_phph = (R * np.sin(TH)) ** 2
    gtt, gtr = -(1.0 + f), f
    alpha = 1.0 / np.sqrt(-gtt)

    uur, uuth, uuph = fields["uur"], fields["uuth"], fields["uuph"]
    uut = np.sqrt(1.0 + g_rr * uur ** 2 + g_thth * uuth ** 2
                  + g_phph * uuph ** 2)
    ut = uut / alpha
    ur = uur - alpha * uut * gtr
    uth = uuth
    uph = uuph
    u_t = g_tt * ut + g_tr * ur
    u_r = g_tr * ut + g_rr * ur
    u_th = g_thth * uth
    u_ph = g_phph * uph

    bbr, bbth, bbph = fields["bbr"], fields["bbth"], fields["bbph"]
    bt = u_r * bbr + u_th * bbth + u_ph * bbph
    br = (bbr + bt * ur) / ut
    bth = (bbth + bt * uth) / ut
    bph = (bbph + bt * uph) / ut
    b_t = g_tt * bt + g_tr * br
    b_r = g_tr * bt + g_rr * br
    b_th = g_thth * bth
    b_ph = g_phph * bph

    return dict(ut=ut, ur=ur, uth=uth, uph=uph,
                u_t=u_t, u_r=u_r, u_th=u_th, u_ph=u_ph,
                bt=bt, br=br, bth=bth, bph=bph,
                b_t=b_t, b_r=b_r, b_th=b_th, b_ph=b_ph,
                alpha=alpha, gtr=gtr, f=f)


def write_athena(path, fields, p, kappa=False, phi_blocks=1):
    """Athena++ .athdf layout the reference parses
    (simulation_reader.cpp:593-781). kappa adds an electron-entropy slice
    named "kappa" (= pgas / rho^gamma) for the code_kappa plasma model;
    phi_blocks > 1 splits the domain into that many mesh blocks along phi
    (for multi-block sampler tests)."""
    import h5py

    n_r, n_th, n_ph = p["n_r"], p["n_th"], p["n_ph"]
    prim_names = ["rho", "press", "vel1", "vel2", "vel3"]
    prim_vals = [fields["rho"], fields["pgas"], fields["uur"],
                 fields["uuth"], fields["uuph"]]
    if kappa:
        prim_names.append("kappa")
        prim_vals.append(fields["pgas"] / fields["rho"] ** p["gamma_adi"])
    nb = phi_blocks
    if n_ph % nb != 0:
        raise ValueError("phi_blocks must divide n_ph")
    npb = n_ph // nb
    with h5py.File(path, "w") as f:
        f.attrs.create("NumCycles", 0, dtype=np.int32)
        f.attrs.create("Time", p["time"], dtype=np.float32)
        f.attrs.create("Coordinates", np.bytes_("kerr-schild"))
        f.attrs.create("RootGridSize", (n_r, n_th, n_ph), dtype=np.int32)
        f.attrs.create("NumMeshBlocks", nb, dtype=np.int32)
        f.attrs.create("MeshBlockSize", (n_r, n_th, npb), dtype=np.int32)
        f.attrs.create("MaxLevel", 0, dtype=np.int32)
        f.attrs.create("NumVariables", [len(prim_names), 3], dtype=np.int32)
        # NUL-padded fixed-width strings (|S21, matching real Athena++
        # output): the reference reader's std::string conversion relies on
        # a terminator inside the fixed-width field
        # (hdf5_format_arrays.cpp:217-222 copies `size` bytes and assigns
        # via char*) - numpy's minimal |S4 would leave "prim" unterminated.
        f.attrs.create("DatasetNames", [np.bytes_("prim"), np.bytes_("B")],
                       dtype="S21")
        f.attrs.create("VariableNames", [
            np.bytes_(s) for s in
            prim_names + ["Bcc1", "Bcc2", "Bcc3"]], dtype="S21")
        f.create_dataset("Levels", data=np.zeros(nb, dtype=np.int32))
        locs = np.zeros((nb, 3), dtype=np.int64)
        locs[:, 2] = np.arange(nb)
        f.create_dataset("LogicalLocations", data=locs)
        rep = lambda a: np.repeat(a[None, :], nb, axis=0)
        f.create_dataset("x1f", data=rep(fields["rf"]).astype(np.float32))
        f.create_dataset("x2f", data=rep(fields["thf"]).astype(np.float32))
        f.create_dataset("x1v", data=rep(fields["r"]).astype(np.float32))
        f.create_dataset("x2v", data=rep(fields["th"]).astype(np.float32))
        x3f = np.stack([fields["phf"][bidx * npb:(bidx + 1) * npb + 1]
                        for bidx in range(nb)])
        x3v = np.stack([fields["ph"][bidx * npb:(bidx + 1) * npb]
                        for bidx in range(nb)])
        f.create_dataset("x3f", data=x3f.astype(np.float32))
        f.create_dataset("x3v", data=x3v.astype(np.float32))
        # (var, block, k, j, i) with k split along phi
        prim = np.stack([np.stack([v[bidx * npb:(bidx + 1) * npb]
                                   for bidx in range(nb)]) for v in prim_vals])
        bfield = np.stack([np.stack([v[bidx * npb:(bidx + 1) * npb]
                                     for bidx in range(nb)])
                           for v in (fields["bbr"], fields["bbth"],
                                     fields["bbph"])])
        f.create_dataset("prim", data=prim.astype(np.float32))
        f.create_dataset("B", data=bfield.astype(np.float32))


def write_athena_amr(path, p, kappa=False, block_size=(16, 8, 4),
                     refine=((0, 0, 0), (0, 1, 0)), pad_block=True):
    """Mixed-refinement Athena++ .athdf: the root grid splits into equal
    mesh blocks and each location in `refine` is replaced by its 8
    level-1 children (standard Athena++ 2:1 octree refinement, the layout
    the reference's interblock AMR sampler handles via FindNearbyInds,
    simulation_sampling.cpp:1068-1321).

    block_size is (n_i, n_j, n_k) cells per block = MeshBlockSize in
    (r, theta, phi); refine entries are level-0 logical locations
    (li, lj, lk).

    pad_block appends one never-sampled sentinel block (coordinates far
    outside the domain, unmatched logical location): the reference's
    interblock ghost formulas literally index one element past a block's
    coordinate/primitive rows (e.g. x1v(b, n_i) at
    simulation_sampling.cpp:519, fine-level cell index i*2 == n_i at
    :1305), which lands in the NEXT block's row of the contiguous Array -
    except for the final block, where it reads unallocated heap and the
    output becomes nondeterministic. The sentinel gives those reads a
    deterministic target so reference goldens are reproducible."""
    import h5py

    n_r, n_th, n_ph = p["n_r"], p["n_th"], p["n_ph"]
    nbr, nbt, nbp = block_size
    if n_r % nbr or n_th % nbt or n_ph % nbp:
        raise ValueError("block_size must divide the root grid")
    layout = (n_r // nbr, n_th // nbt, n_ph // nbp)
    refine = {tuple(t) for t in refine}
    for t in refine:
        if not all(0 <= t[ax] < layout[ax] for ax in range(3)):
            raise ValueError(f"refine location {t} outside layout {layout}")

    # Block list: unrefined roots in (lk, lj, li) order, then children.
    blocks = []                  # (level, li, lj, lk)
    for lk in range(layout[2]):
        for lj in range(layout[1]):
            for li in range(layout[0]):
                if (li, lj, lk) in refine:
                    continue
                blocks.append((0, li, lj, lk))
    for (li, lj, lk) in sorted(refine):
        for ck in range(2):
            for cj in range(2):
                for ci in range(2):
                    blocks.append((1, 2 * li + ci, 2 * lj + cj, 2 * lk + ck))
    nb = len(blocks) + (1 if pad_block else 0)

    def block_coords(level, li, lj, lk):
        scale = 1 << level
        lrf_all = np.linspace(np.log(p["r_min"]), np.log(p["r_max"]),
                              n_r * scale + 1)
        thf_all = np.linspace(0.0, np.pi, n_th * scale + 1)
        phf_all = np.linspace(0.0, 2.0 * np.pi, n_ph * scale + 1)
        lrf = lrf_all[li * nbr:(li + 1) * nbr + 1]
        thf = thf_all[lj * nbt:(lj + 1) * nbt + 1]
        phf = phf_all[lk * nbp:(lk + 1) * nbp + 1]
        r = np.exp(0.5 * (lrf[:-1] + lrf[1:]))
        th = 0.5 * (thf[:-1] + thf[1:])
        ph = 0.5 * (phf[:-1] + phf[1:])
        return np.exp(lrf), thf, phf, r, th, ph

    prim_names = ["rho", "press", "vel1", "vel2", "vel3"]
    if kappa:
        prim_names.append("kappa")
    x1f = np.zeros((nb, nbr + 1))
    x2f = np.zeros((nb, nbt + 1))
    x3f = np.zeros((nb, nbp + 1))
    x1v = np.zeros((nb, nbr))
    x2v = np.zeros((nb, nbt))
    x3v = np.zeros((nb, nbp))
    prim = np.zeros((len(prim_names), nb, nbp, nbt, nbr))
    bfield = np.zeros((3, nb, nbp, nbt, nbr))
    levels = np.zeros(nb, dtype=np.int32)
    locs = np.zeros((nb, 3), dtype=np.int64)
    for bidx, (level, li, lj, lk) in enumerate(blocks):
        rf, thf, phf, r, th, ph = block_coords(level, li, lj, lk)
        x1f[bidx], x2f[bidx], x3f[bidx] = rf, thf, phf
        x1v[bidx], x2v[bidx], x3v[bidx] = r, th, ph
        levels[bidx] = level
        locs[bidx] = (li, lj, lk)
        fl = eval_fields(p, r, th, ph)
        vals = [fl["rho"], fl["pgas"], fl["uur"], fl["uuth"], fl["uuph"]]
        if kappa:
            vals.append(fl["pgas"] / fl["rho"] ** p["gamma_adi"])
        for v_i, v in enumerate(vals):
            prim[v_i, bidx] = v
        for v_i, v in enumerate((fl["bbr"], fl["bbth"], fl["bbph"])):
            bfield[v_i, bidx] = v

    if pad_block:
        # Sentinel (see docstring): far-away coordinates so no sample or
        # neighbor lookup ever touches it; floor values in the cells.
        bidx = nb - 1
        x1f[bidx] = np.linspace(1.0e3, 1.001e3, nbr + 1)
        x2f[bidx] = np.linspace(0.0, np.pi, nbt + 1)
        x3f[bidx] = np.linspace(0.0, 2.0 * np.pi, nbp + 1)
        x1v[bidx] = 0.5 * (x1f[bidx][:-1] + x1f[bidx][1:])
        x2v[bidx] = 0.5 * (x2f[bidx][:-1] + x2f[bidx][1:])
        x3v[bidx] = 0.5 * (x3f[bidx][:-1] + x3f[bidx][1:])
        levels[bidx] = 0
        locs[bidx] = (9999, 9999, 9999)
        prim[0, bidx] = p["rho_floor"]
        prim[1, bidx] = p["pgas_floor"]
        if kappa:
            prim[-1, bidx] = p["pgas_floor"] / p["rho_floor"] ** p["gamma_adi"]

    with h5py.File(path, "w") as f:
        f.attrs.create("NumCycles", 0, dtype=np.int32)
        f.attrs.create("Time", p["time"], dtype=np.float32)
        f.attrs.create("Coordinates", np.bytes_("kerr-schild"))
        f.attrs.create("RootGridSize", (n_r, n_th, n_ph), dtype=np.int32)
        f.attrs.create("NumMeshBlocks", nb, dtype=np.int32)
        f.attrs.create("MeshBlockSize", (nbr, nbt, nbp), dtype=np.int32)
        f.attrs.create("MaxLevel", 1, dtype=np.int32)
        f.attrs.create("NumVariables", [len(prim_names), 3], dtype=np.int32)
        # NUL-padded |S21 strings (see write_athena)
        f.attrs.create("DatasetNames", [np.bytes_("prim"), np.bytes_("B")],
                       dtype="S21")
        f.attrs.create("VariableNames", [
            np.bytes_(s) for s in prim_names + ["Bcc1", "Bcc2", "Bcc3"]],
            dtype="S21")
        f.create_dataset("Levels", data=levels)
        f.create_dataset("LogicalLocations", data=locs)
        f.create_dataset("x1f", data=x1f.astype(np.float32))
        f.create_dataset("x2f", data=x2f.astype(np.float32))
        f.create_dataset("x3f", data=x3f.astype(np.float32))
        f.create_dataset("x1v", data=x1v.astype(np.float32))
        f.create_dataset("x2v", data=x2v.astype(np.float32))
        f.create_dataset("x3v", data=x3v.astype(np.float32))
        f.create_dataset("prim", data=prim.astype(np.float32))
        f.create_dataset("B", data=bfield.astype(np.float32))


def write_iharm3d(path, fields, p):
    """iharm3d HDF5 layout (simulation_reader.cpp:345-431, 622-660, 782-807):
    MKS grid with given hslope; prims = (n1,n2,n3,8) float32 with modified
    normal-frame velocity and modified cell-frame B."""
    import h5py

    h = p["hslope"]
    lrf, thf, phf = fields["lrf"], fields["thf"], fields["phf"]
    if h != 1.0:
        raise NotImplementedError("mock iharm3d supports hslope=1 only")
    x2f = thf / np.pi
    dlr = lrf[1] - lrf[0]
    dx2 = x2f[1] - x2f[0]
    dph = phf[1] - phf[0]

    fr = _sks_frames(fields, p)
    R = fields["r"][None, None, :]
    # SKS coordinate frame -> modified coordinate frame (x1=log r, x2=th/pi)
    u0, u1, u2, u3 = fr["ut"], fr["ur"] / R, fr["uth"] / np.pi, fr["uph"]
    b0, b1, b2, b3 = fr["bt"], fr["br"] / R, fr["bth"] / np.pi, fr["bph"]
    u_1 = fr["u_r"] * R
    u_2 = fr["u_th"] * np.pi
    u_3 = fr["u_ph"]
    # Modified coordinate frame -> modified normal frame
    g00 = -(1.0 + fr["f"])
    g01 = fr["gtr"] / R
    alpha_mod = 1.0 / np.sqrt(-g00)
    uu0 = alpha_mod * u0
    uu1 = u1 + alpha_mod * uu0 * g01
    uu2 = u2
    uu3 = u3
    # Modified cell-frame field
    bb1 = b1 * u0 - b0 * u1
    bb2 = b2 * u0 - b0 * u2
    bb3 = b3 * u0 - b0 * u3
    del u_1, u_2, u_3

    ugas = fields["pgas"] / (p["gamma_adi"] - 1.0)
    prims = np.stack([fields["rho"], ugas, uu1, uu2, uu3, bb1, bb2, bb3])
    # (var, ph, th, r) -> (r, th, ph, var)
    prims = prims.transpose(3, 2, 1, 0).astype(np.float32)

    with h5py.File(path, "w") as f:
        f.create_dataset("header/version", data=[np.bytes_("mock-blacklight")])
        f.create_dataset("header/gam", data=p["gamma_adi"], dtype=np.float64)
        f.create_dataset("header/n1", data=p["n_r"], dtype=np.int32)
        f.create_dataset("header/n2", data=p["n_th"], dtype=np.int32)
        f.create_dataset("header/n3", data=p["n_ph"], dtype=np.int32)
        f.create_dataset("header/metric", data=[np.bytes_("MKS")])
        f.create_dataset("header/n_prim", data=8, dtype=np.int32)
        f.create_dataset("header/prim_names", data=[
            np.bytes_(s) for s in
            ("RHO", "UU", "U1", "U2", "U3", "B1", "B2", "B3")])
        f.create_dataset("header/geom/startx1", data=lrf[0], dtype=np.float64)
        f.create_dataset("header/geom/startx2", data=x2f[0], dtype=np.float64)
        f.create_dataset("header/geom/startx3", data=phf[0], dtype=np.float64)
        f.create_dataset("header/geom/dx1", data=dlr, dtype=np.float64)
        f.create_dataset("header/geom/dx2", data=dx2, dtype=np.float64)
        f.create_dataset("header/geom/dx3", data=dph, dtype=np.float64)
        f.create_dataset("header/geom/mks/a", data=0.0, dtype=np.float64)
        f.create_dataset("header/geom/mks/hslope", data=h, dtype=np.float64)
        f.create_dataset("header/geom/mks/r_in", data=fields["rf"][0],
                         dtype=np.float64)
        f.create_dataset("header/geom/mks/r_out", data=fields["rf"][-1],
                         dtype=np.float64)
        f.create_dataset("t", data=p["time"], dtype=np.float64)
        f.create_dataset("prims", data=prims)


def write_iharm3d_fmks(path, fields, p, hslope=0.3, mks_smooth=0.5,
                       poly_xt=0.82, poly_alpha=14.0):
    """iharm3d HDF5 with FMKS (MMKS) coordinates: same physical torus, but
    the native grid is uniform in (x^1=log r, x^2 in [0,1]) with the
    hyper-exponential FMKS theta map. Exercises the reader's inverse-map
    sampling path."""
    import h5py

    from blacklight.grid import mks

    lrf, phf = fields["lrf"], fields["phf"]
    n_r, n_th, n_ph = p["n_r"], p["n_th"], p["n_ph"]
    params = mks.FmksParams(h=hslope, r_in=float(np.exp(lrf[0])),
                            poly_xt=poly_xt, poly_alpha=poly_alpha,
                            mks_smooth=mks_smooth)
    x2f = np.linspace(0.0, 1.0, n_th + 1)
    x1v = 0.5 * (lrf[:-1] + lrf[1:])
    x2v = 0.5 * (x2f[:-1] + x2f[1:])
    phv = fields["ph"]
    dlr = lrf[1] - lrf[0]
    dx2 = x2f[1] - x2f[0]
    dph = phf[1] - phf[0]

    # Physical fields at the FMKS cell centers
    X1 = np.broadcast_to(x1v[None, None, :], (n_ph, n_th, n_r))
    X2 = np.broadcast_to(x2v[None, :, None], (n_ph, n_th, n_r))
    R, TH = mks.fmks_sks_coords(X1, X2, params)

    keep = ((R >= p["cutoff_r_min"]) & (R <= p["cutoff_r_max"])
            & (TH >= p["cutoff_th_min"]) & (TH <= np.pi - p["cutoff_th_min"]))

    def torus(amp, power, scale, floor=0.0):
        v = amp * R ** -power * np.exp(-np.abs(TH - np.pi / 2.0) / scale)
        return np.maximum(np.where(keep, v, 0.0), floor)

    rho = torus(p["rho_amp"], p["rho_r_power"], p["rho_th_scale"],
                p["rho_floor"])
    pgas = torus(p["pgas_amp"], p["pgas_r_power"], p["pgas_th_scale"],
                 p["pgas_floor"])
    uuph_sks = torus(p["uph_amp"], p["uph_r_power"], p["uph_th_scale"])
    rcyl = np.maximum(R * np.sin(TH), p["cutoff_r_min"])
    bbz = p["bz_amp"] * rcyl ** -p["bz_r_power"]
    bbr_sks = np.cos(TH) * bbz
    bbth_sks = -np.sin(TH) / R * bbz
    # B is NOT cut off to the torus (matches make_fields)
    bbph_sks = (p["bph_amp"] * R ** -p["bph_r_power"]
                * np.exp(-np.abs(TH - np.pi / 2.0) / p["bph_th_scale"]))
    if not p["bph_no_flip"]:
        bbph_sks = bbph_sks * np.where(TH > np.pi / 2.0, -1.0, 1.0)

    # SKS normal frame -> SKS coordinate frame (a=0)
    f2 = 2.0 / R
    g_rr = 1.0 + f2
    g_thth = R ** 2
    g_phph = (R * np.sin(TH)) ** 2
    gtt, gtr = -(1.0 + f2), f2
    alpha = 1.0 / np.sqrt(-gtt)
    uut = np.sqrt(1.0 + g_phph * uuph_sks ** 2)
    ut = uut / alpha
    ur = -alpha * uut * gtr
    uth = np.zeros_like(ut)
    uph = uuph_sks
    u_r = gtr * ut + g_rr * ur
    u_th = g_thth * uth
    u_ph = g_phph * uph
    bt = u_r * bbr_sks + u_th * bbth_sks + u_ph * bbph_sks
    br = (bbr_sks + bt * ur) / ut
    bth = (bbth_sks + bt * uth) / ut
    bph = (bbph_sks + bt * uph) / ut

    # SKS coordinate frame -> native FMKS coordinate frame
    dr_dx1, dth_dx1, dth_dx2 = mks.jacobian_factors(X1, X2, "fmks", params)
    u1 = ur / dr_dx1
    u2 = (uth - dth_dx1 * u1) / dth_dx2
    u3 = uph
    b1 = br / dr_dx1
    b2 = (bth - dth_dx1 * b1) / dth_dx2
    b3 = bph

    # Native coordinate frame -> native normal frame (inverse of the
    # loader's chain; a=0 so g_tth = gtph = 0)
    g00 = gtt
    g01 = gtr / dr_dx1
    g02 = -dth_dx1 * gtr / (dr_dx1 * dth_dx2)
    alpha_mod = 1.0 / np.sqrt(-g00)
    uu0 = alpha_mod * ut
    uu1 = u1 + alpha_mod * g01 * uu0
    uu2 = u2 + alpha_mod * g02 * uu0
    uu3 = u3
    bb1 = b1 * ut - bt * u1
    bb2 = b2 * ut - bt * u2
    bb3 = b3 * ut - bt * u3

    ugas = pgas / (p["gamma_adi"] - 1.0)
    prims = np.stack([rho, ugas, uu1, uu2, uu3, bb1, bb2, bb3])
    prims = prims.transpose(3, 2, 1, 0).astype(np.float32)

    with h5py.File(path, "w") as f:
        f.create_dataset("header/version", data=[np.bytes_("mock-blacklight")])
        f.create_dataset("header/gam", data=p["gamma_adi"], dtype=np.float64)
        f.create_dataset("header/n1", data=n_r, dtype=np.int32)
        f.create_dataset("header/n2", data=n_th, dtype=np.int32)
        f.create_dataset("header/n3", data=n_ph, dtype=np.int32)
        f.create_dataset("header/metric", data=[np.bytes_("FMKS")])
        f.create_dataset("header/n_prim", data=8, dtype=np.int32)
        f.create_dataset("header/prim_names", data=[
            np.bytes_(s) for s in
            ("RHO", "UU", "U1", "U2", "U3", "B1", "B2", "B3")])
        f.create_dataset("header/geom/startx1", data=lrf[0], dtype=np.float64)
        f.create_dataset("header/geom/startx2", data=0.0, dtype=np.float64)
        f.create_dataset("header/geom/startx3", data=phf[0], dtype=np.float64)
        f.create_dataset("header/geom/dx1", data=dlr, dtype=np.float64)
        f.create_dataset("header/geom/dx2", data=dx2, dtype=np.float64)
        f.create_dataset("header/geom/dx3", data=dph, dtype=np.float64)
        f.create_dataset("header/geom/fmks/a", data=0.0, dtype=np.float64)
        f.create_dataset("header/geom/fmks/hslope", data=hslope,
                         dtype=np.float64)
        f.create_dataset("header/geom/fmks/r_in", data=params.r_in,
                         dtype=np.float64)
        f.create_dataset("header/geom/fmks/poly_xt", data=poly_xt,
                         dtype=np.float64)
        f.create_dataset("header/geom/fmks/poly_alpha", data=poly_alpha,
                         dtype=np.float64)
        f.create_dataset("header/geom/fmks/mks_smooth", data=mks_smooth,
                         dtype=np.float64)
        f.create_dataset("t", data=p["time"], dtype=np.float64)
        f.create_dataset("prims", data=prims)
    return phv


def write_harm3d(path, fields, p):
    """harm3d ASCII header + float32 binary (simulation_reader.cpp:661-718,
    808-850): 6 coordinate columns + rho, ugas, u^mu, b^mu in the modified
    coordinate frame."""
    if p["hslope"] != 1.0:
        raise NotImplementedError("mock harm3d supports hslope=1 only")
    lrf, thf, phf = fields["lrf"], fields["thf"], fields["phf"]
    x2f = thf / np.pi
    dlr = lrf[1] - lrf[0]
    dx2 = x2f[1] - x2f[0]
    dph = phf[1] - phf[0]
    lr = np.log(fields["r"])
    x2 = fields["th"] / np.pi
    ph = fields["ph"]

    fr = _sks_frames(fields, p)
    R = fields["r"][None, None, :]
    u0, u1, u2, u3 = fr["ut"], fr["ur"] / R, fr["uth"] / np.pi, fr["uph"]
    b0, b1, b2, b3 = fr["bt"], fr["br"] / R, fr["bth"] / np.pi, fr["bph"]
    ugas = fields["pgas"] / (p["gamma_adi"] - 1.0)

    n_r, n_th, n_ph = p["n_r"], p["n_th"], p["n_ph"]
    cols = [
        np.broadcast_to(lr[None, None, :], (n_ph, n_th, n_r)),
        np.broadcast_to(x2[None, :, None], (n_ph, n_th, n_r)),
        np.broadcast_to(ph[:, None, None], (n_ph, n_th, n_r)),
        np.broadcast_to(fields["r"][None, None, :], (n_ph, n_th, n_r)),
        np.broadcast_to(fields["th"][None, :, None], (n_ph, n_th, n_r)),
        np.broadcast_to(ph[:, None, None], (n_ph, n_th, n_r)),
        fields["rho"], ugas, u0, u1, u2, u3, b0, b1, b2, b3,
    ]
    # (col, ph, th, r) -> (r, th, ph, col)
    table = np.stack(cols).transpose(3, 2, 1, 0).astype(np.float32)

    with open(path, "wb") as f:
        header = (f"{p['time']} {n_r} {n_th} {n_ph} "
                  f"{lrf[0]:24.16e} {x2f[0]:24.16e} {phf[0]:24.16e} "
                  f"{dlr:24.16e} {dx2:24.16e} {dph:24.16e} "
                  f"0.0 {p['gamma_adi']:24.16e} {fields['rf'][0]:24.16e} "
                  f"1.0 8\n")
        f.write(header.encode())
        table.tofile(f)


def write_athenak(path, fields, p, n_xyz=None, half_width=None):
    """AthenaK binary v1.1 (simulation_reader.cpp:915-1014, 433-588): one
    uniform CKS block sampling the analytic torus on Cartesian cells."""
    n = n_xyz or max(p["n_r"], 32)
    w = half_width or p["r_max"] / np.sqrt(2.0)
    xf = np.linspace(-w, w, n + 1)
    xv = 0.5 * (xf[:-1] + xf[1:])
    X, Y, Z = np.meshgrid(xv, xv, xv, indexing="ij")
    X = X.transpose(2, 1, 0)  # (z, y, x) ordering, k fastest over z
    Y = Y.transpose(2, 1, 0)
    Z = Z.transpose(2, 1, 0)
    R = np.sqrt(X ** 2 + Y ** 2 + Z ** 2)
    TH = np.arccos(np.clip(Z / np.maximum(R, 1e-300), -1.0, 1.0))
    PH = np.mod(np.arctan2(Y, X), 2.0 * np.pi)

    def torus(amp, power, scale, floor=0.0):
        v = amp * R ** -power * np.exp(-np.abs(TH - np.pi / 2.0) / scale)
        keep = ((R >= p["cutoff_r_min"]) & (R <= p["cutoff_r_max"])
                & (TH >= p["cutoff_th_min"]) & (TH <= np.pi - p["cutoff_th_min"]))
        return np.maximum(np.where(keep, v, 0.0), floor)

    rho = torus(p["rho_amp"], p["rho_r_power"], p["rho_th_scale"],
                p["rho_floor"])
    pgas = torus(p["pgas_amp"], p["pgas_r_power"], p["pgas_th_scale"],
                 p["pgas_floor"])
    uuph_sks = torus(p["uph_amp"], p["uph_r_power"], p["uph_th_scale"])
    rcyl = np.maximum(R * np.sin(TH), p["cutoff_r_min"])
    bbz = p["bz_amp"] * rcyl ** -p["bz_r_power"]
    bbr_sks = np.cos(TH) * bbz
    bbth_sks = -np.sin(TH) / R * bbz
    # B is NOT cut off to the torus (matches make_fields)
    bbph_sks = (p["bph_amp"] * R ** -p["bph_r_power"]
                * np.exp(-np.abs(TH - np.pi / 2.0) / p["bph_th_scale"]))
    if not p["bph_no_flip"]:
        bbph_sks = bbph_sks * np.where(TH > np.pi / 2.0, -1.0, 1.0)

    # SKS normal frame -> SKS coordinate frame (a=0)
    f2 = 2.0 / R
    g_rr = 1.0 + f2
    g_thth = R ** 2
    g_phph = (R * np.sin(TH)) ** 2
    gtt, gtr = -(1.0 + f2), f2
    alpha = 1.0 / np.sqrt(-gtt)
    uut = np.sqrt(1.0 + g_phph * uuph_sks ** 2)
    ut = uut / alpha
    ur = -alpha * uut * gtr
    uth = np.zeros_like(ut)
    uph = uuph_sks
    u_r = gtr * ut + g_rr * ur
    u_th = g_thth * uth
    u_ph = g_phph * uph
    bt = u_r * bbr_sks + u_th * bbth_sks + u_ph * bbph_sks
    br = (bbr_sks + bt * ur) / ut
    bth = (bbth_sks + bt * uth) / ut
    bph = (bbph_sks + bt * uph) / ut

    # SKS -> CKS vector components (a=0: dx/dr = sin th cos ph, ...)
    sth, cth = np.sin(TH), np.cos(TH)
    sph, cph = np.sin(PH), np.cos(PH)

    def to_cks(vr, vth, vph):
        vx = sth * cph * vr + R * cth * cph * vth - R * sth * sph * vph
        vy = sth * sph * vr + R * cth * sph * vth + R * sth * cph * vph
        vz = cth * vr - R * sth * vth
        return vx, vy, vz

    ux, uy, uz = to_cks(ur, uth, uph)
    bx, by, bz = to_cks(br, bth, bph)

    # CKS coordinate frame -> CKS normal frame (a=0: g^tt=-(1+f),
    # g^{ti} = f l^i with l^i = x^i/r, alpha = 1/sqrt(1+f))
    fc = 2.0 / R
    alpha_c = 1.0 / np.sqrt(1.0 + fc)
    lx, ly, lz = X / R, Y / R, Z / R
    uux = ux + alpha_c ** 2 * fc * lx * ut
    uuy = uy + alpha_c ** 2 * fc * ly * ut
    uuz = uz + alpha_c ** 2 * fc * lz * ut
    bbx = bx * ut - bt * ux
    bby = by * ut - bt * uy
    bbz_c = bz * ut - bt * uz

    eint = pgas / (p["gamma_adi"] - 1.0)
    variables = [("dens", rho), ("velx", uux), ("vely", uuy), ("velz", uuz),
                 ("eint", eint), ("bcc1", bbx), ("bcc2", bby), ("bcc3", bbz_c)]

    param_text = ("<coord>\na = 0.0\n<mhd>\ngamma = "
                  f"{p['gamma_adi']}\n").encode()
    with open(path, "wb") as f:
        f.write(b"Athena binary output version=1.1\n")
        f.write(b"  size of preheader=5\n")
        f.write(f"  time={p['time']}\n".encode())
        f.write(b"  cycle=0\n")
        f.write(b"  size of location=8\n")
        f.write(b"  size of variable=4\n")
        f.write(f"  number of variables={len(variables)}\n".encode())
        f.write(("  variables:" + "".join("  " + n for n, _ in variables)
                 + "\n").encode())
        f.write(f"  header offset={len(param_text)}\n".encode())
        f.write(param_text)
        # One block covering the whole domain
        idx = np.array([0, n - 1, 0, n - 1, 0, n - 1], dtype=np.int32)
        f.write(idx.tobytes())
        f.write(np.zeros(3, dtype=np.int32).tobytes())  # logical location
        f.write(np.zeros(1, dtype=np.int32).tobytes())  # level
        f.write(np.array([-w, w, -w, w, -w, w], dtype=np.float64).tobytes())
        for _, arr in variables:
            f.write(np.ascontiguousarray(arr, dtype=np.float32).tobytes())


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("filename")
    parser.add_argument("--format", default="athena",
                        choices=("athena", "athenak", "iharm3d", "harm3d"))
    for key, val in DEFAULTS.items():
        if isinstance(val, bool):
            parser.add_argument(f"--{key}", action="store_true")
        else:
            parser.add_argument(f"--{key}", type=type(val), default=val)
    parser.add_argument("--amr", action="store_true",
                        help="write a mixed-refinement athena snapshot")
    args = vars(parser.parse_args())
    fmt = args.pop("format")
    path = args.pop("filename")
    amr = args.pop("amr")
    if amr:
        if fmt != "athena":
            raise SystemExit("--amr requires --format athena")
        write_athena_amr(path, args)
        return
    fields = make_fields(args)
    writer = {"athena": write_athena, "athenak": write_athenak,
              "iharm3d": write_iharm3d, "harm3d": write_harm3d}[fmt]
    writer(path, fields, args)


if __name__ == "__main__":
    main()
