"""Polarized (full-Stokes IQUV) radiative transfer.

Re-derivation of the reference integrator (src/radiation_integrator/
polarized.cpp:51-973): the state is the complex coherency tensor N^{munu}
per (ray, frequency), evolved far-end -> camera with Strang-split parallel
transport around matter coupling in a fluid tetrad frame:

  per sample: transport N by half step (Euler, averaged connection/k)
              -> build fluid tetrad (e_0 = u, e_3 ~ k, e_2 ~ b)
              -> N -> tetrad Stokes (I 14)
              -> matter coupling (polarized_coupling.py)
              -> Stokes -> N (I 13), back to coordinates
              -> transport by second half step
  finally:    camera-frame tetrad per pixel -> Stokes I, Q, U, V; nu^3 scale.

Because the coupling operators do not commute along the ray, samples must
be processed far-end -> camera while the geodesic integrates camera ->
far-end. Instead of materializing all (S, B) samples, the integrator
sqrt-checkpoints the geodesic sweep (ops/geodesic.segment_carries) and
replays one window of steps at a time in reverse segment order -
bit-identical samples at O(S/window + window) memory - so arbitrarily
large bundles stream without chunking. Each sample's second-half
transport (whose step length belongs to the NEXT, nearer sample) is
deferred to that next sample's iteration, so the scan needs no lookahead.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from blacklight.constants import HIGHEST, NUM_CELL_VALUES, Physics
from blacklight.ops import connection as connection_mod
from blacklight.ops import geodesic, geometry
from blacklight.ops.tetrad import tetrad_rows_c
from blacklight.transfer.polarized_coupling import couple_matter_c
from blacklight.transfer.unpolarized import DELTA_TAU_MAX, ImageOptions
from blacklight.utils.errors import BlacklightError

# Hermitian coherency-tensor component bookkeeping: N^{mn} with real
# rotation/absorption operators stays Hermitian throughout (transport
# dN = -(A N + N A^T) with real A, tetrad congruences, and the 2x2
# Stokes reconstruction all preserve it), so only 10 real-symmetric and
# 6 imaginary-antisymmetric components are carried - as individual flat
# (B*F,) arrays so every update is a full-width VPU op instead of math on
# (B, F, 4, 4) tiles whose trailing 4x4 wastes 63/64 of each (8, 128) tile.
_SYM = ((0, 0), (0, 1), (0, 2), (0, 3), (1, 1), (1, 2), (1, 3), (2, 2),
        (2, 3), (3, 3))
_ANT = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
_SYM_POS = {}
for _i, (_m, _n) in enumerate(_SYM):
    _SYM_POS[(_m, _n)] = _i
    _SYM_POS[(_n, _m)] = _i
_ANT_POS = {mn: i for i, mn in enumerate(_ANT)}


def _re_at(re, m, n):
    return re[_SYM_POS[(m, n)]]


def _im_at(im, m, n):
    """Im N^{mn} with antisymmetry folded in; None when structurally 0."""
    if m == n:
        return None
    if m < n:
        return im[_ANT_POS[(m, n)]]
    return -im[_ANT_POS[(n, m)]]


def _transport_c(a_mat, re, im, base_re, base_im, dl):
    """Half-step parallel transport on coherency components
    (polarized.cpp:174-192): new = base - dl (A^m_b N^{bn} + A^n_b N^{mb}),
    expanded per stored component with Hermitian symmetry."""
    new_re = []
    for i, (m, n) in enumerate(_SYM):
        d = None
        for bb in range(4):
            t = a_mat[m][bb] * _re_at(re, bb, n) \
                + a_mat[n][bb] * _re_at(re, m, bb)
            d = t if d is None else d + t
        new_re.append(base_re[i] - dl * d)
    new_im = []
    for i, (m, n) in enumerate(_ANT):
        d = None
        for bb in range(4):
            v = _im_at(im, bb, n)
            if v is not None:
                t = a_mat[m][bb] * v
                d = t if d is None else d + t
            v = _im_at(im, m, bb)
            if v is not None:
                t = a_mat[n][bb] * v
                d = t if d is None else d + t
        new_im.append(base_im[i] - dl * d)
    return tuple(new_re), tuple(new_im)


def _stokes_from_n(e1, e2, re, im):
    """Tetrad-frame Stokes (I, Q, U, V) from coherency components
    (polarized.cpp:264-292 + I 14): only the (1,2)x(1,2) block of the
    tetrad-projected N feeds the Stokes vector. e1/e2 are the COVARIANT
    tetrad rows as 4-lists of flat arrays."""
    nt00 = None
    nt11 = None
    nt01 = None
    for m in range(4):
        t00 = e1[m] * e1[m] * _re_at(re, m, m)
        t11 = e2[m] * e2[m] * _re_at(re, m, m)
        t01 = e1[m] * e2[m] * _re_at(re, m, m)
        nt00 = t00 if nt00 is None else nt00 + t00
        nt11 = t11 if nt11 is None else nt11 + t11
        nt01 = t01 if nt01 is None else nt01 + t01
    for i, (m, n) in enumerate(_ANT):
        r = re[_SYM_POS[(m, n)]]
        nt00 = nt00 + 2.0 * e1[m] * e1[n] * r
        nt11 = nt11 + 2.0 * e2[m] * e2[n] * r
        nt01 = nt01 + (e1[m] * e2[n] + e1[n] * e2[m]) * r
    s_v = None
    for i, (m, n) in enumerate(_ANT):
        t = (e2[m] * e1[n] - e2[n] * e1[m]) * im[i]
        s_v = t if s_v is None else s_v + t
    return (0.5 * (nt00 + nt11), 0.5 * (nt00 - nt11), nt01, s_v)


def _n_from_stokes(t1, t2, s_i, s_q, s_u, s_v):
    """Coherency components from tetrad-frame Stokes (I 13 +
    polarized.cpp:793-813): N_tet is nonzero only in the transverse 2x2
    block, so N^{mn} = t1^m t1^n (I+Q) + (t1^m t2^n + t2^m t1^n) U
    + t2^m t2^n (I-Q) - i V (t1^m t2^n - t2^m t1^n). t1/t2 are the
    CONTRAVARIANT tetrad rows as 4-lists of flat arrays."""
    ipq = s_i + s_q
    imq = s_i - s_q
    re = tuple(
        t1[m] * t1[n] * ipq + (t1[m] * t2[n] + t2[m] * t1[n]) * s_u
        + t2[m] * t2[n] * imq
        for (m, n) in _SYM)
    im = tuple(s_v * (t2[m] * t1[n] - t1[m] * t2[n]) for (m, n) in _ANT)
    return re, im


def camera_stokes(nn_re, nn_im, positions, directions, spin, mass, flat,
                  frequencies, camera_u_con, camera_u_cov,
                  camera_vert_con_c, log_j_scale):
    """Camera-frame Stokes extraction (polarized.cpp:846-949): build the
    camera tetrad per pixel, project the final coherency components, and
    apply the nu^3 invariant scale.

    Args:
      nn_re / nn_im: 10- / 6-tuples (or stacked (..., 10)/(..., 6) arrays)
        of flat (B*F,) coherency components in _SYM/_ANT order.

    Returns (I, Q, U, V), each (B, F).
    """
    b = positions.shape[0]
    f = frequencies.shape[0]
    if not isinstance(nn_re, (tuple, list)):
        nn_re = tuple(nn_re[..., i].reshape(b * f) for i in range(10))
        nn_im = tuple(nn_im[..., i].reshape(b * f) for i in range(6))
    dtype = positions.dtype
    kcon = _kcon_scalar(positions, directions, spin, mass, flat)
    up_con = jnp.concatenate([
        (camera_u_con[0] * camera_vert_con_c[0]
         - (camera_u_cov[1] * camera_vert_con_c[1]
            + camera_u_cov[2] * camera_vert_con_c[2]
            + camera_u_cov[3] * camera_vert_con_c[3]) / camera_u_cov[0])[None],
        camera_vert_con_c[1:] + camera_u_con[1:] * camera_vert_con_c[0],
    ])
    up_con = jnp.broadcast_to(up_con, (b, 4))
    u_con_b = jnp.broadcast_to(camera_u_con, (b, 4))
    if flat:
        f_cam = jnp.zeros_like(positions[:, 0])
        l_cam = (f_cam, f_cam, f_cam)
    else:
        _, f_cam, l_cam_v = geometry.ks_scalars(positions[:, 1:4], spin, mass)
        l_cam = (l_cam_v[:, 0], l_cam_v[:, 1], l_cam_v[:, 2])
    u_cov_b = jnp.broadcast_to(camera_u_cov, (b, 4))
    _, _, e1c_cam, e2c_cam = tetrad_rows_c(
        tuple(u_con_b[:, m] for m in range(4)),
        tuple(kcon[:, m] for m in range(4)),
        tuple(directions[:, m] for m in range(4)),
        tuple(up_con[:, m] for m in range(4)), f_cam, l_cam,
        ucov=tuple(u_cov_b[:, m] for m in range(4)))
    e1_cov = jnp.stack(e1c_cam, axis=-1)
    e2_cov = jnp.stack(e2c_cam, axis=-1)

    def _exf(x):
        if f == 1:
            return x
        return jnp.repeat(x, f, total_repeat_length=b * f)

    e1 = [_exf(e1_cov[:, m]) for m in range(4)]
    e2 = [_exf(e2_cov[:, m]) for m in range(4)]
    ss_i, ss_q, ss_u, ss_v = _stokes_from_n(e1, e2, nn_re, nn_im)
    scale = jnp.exp(jnp.asarray(log_j_scale, dtype)
                    + 3.0 * jnp.log(frequencies[None, :].astype(dtype)))
    return (ss_i.reshape(b, f) * scale, ss_q.reshape(b, f) * scale,
            ss_u.reshape(b, f) * scale, ss_v.reshape(b, f) * scale)


def _kcon_scalar(pos, kcov, spin, mass, flat):
    """g^{munu} k_nu via the Kerr-Schild rank-1 structure."""
    if flat:
        return jnp.concatenate([-kcov[..., :1], kcov[..., 1:]], axis=-1)
    _, f, l_lower = geometry.ks_scalars(pos[..., 1:4], spin, mass)
    l1, l2, l3 = l_lower[..., 0], l_lower[..., 1], l_lower[..., 2]
    lp = -kcov[..., 0] + l1 * kcov[..., 1] + l2 * kcov[..., 2] + l3 * kcov[..., 3]
    flp = f * lp
    return jnp.stack([-kcov[..., 0] + flp,
                      kcov[..., 1] - flp * l1,
                      kcov[..., 2] - flp * l2,
                      kcov[..., 3] - flp * l3], axis=-1)


def integrate_polarized(positions, directions, momentum_factors, frequencies,
                        *, params: geodesic.GeodesicParams,
                        coeff_fn: Callable, opts: ImageOptions,
                        mass_msun: float, camera_x, camera_u_con, camera_u_cov,
                        camera_vert_con_c, log_j_scale=0.0,
                        rotation_split: bool = False, stored=None,
                        stored_prims=None, cell_fn=None, window: int = 64):
    """Full-Stokes transfer over a pixel bundle.

    Args:
      coeff_fn: (pos (B,4), kcov (B,4)) -> dict with (B, F) scaled j_i/j_q/j_v
        and unscaled alpha_i/alpha_q/alpha_v, rho_q/rho_v, plus (B, 4) 'ucon',
        'bcon' and (B,) 'b_zero' for the tetrad.
      cell_fn: (pos, kcov) -> (B, NUM_CELL_VALUES) diagnostics (NaN where
        invalid) for the *_ave / tau_int images (polarized.cpp:338-371).

    Returns dict with I_nu/Q_nu/U_nu/V_nu (B, F) plus auxiliary image planes
    and _flags/_n_samples.
    """
    need_cells = opts.lambda_ave or opts.emission_ave or opts.tau_int
    if need_cells and cell_fn is None:
        raise BlacklightError(
            "cell_fn required for lambda_ave/emission_ave/tau_int")

    b = positions.shape[0]
    f = frequencies.shape[0]
    dtype = positions.dtype
    x_unit = Physics.gg_msun * mass_msun / (Physics.c * Physics.c)
    t_unit = x_unit / Physics.c

    if stored is not None:
        # Checkpointed samples: stream the stored (S, B) rows in reverse.
        # No compaction is needed (dp holes included): the scan carries
        # the previously processed VALID sample, so invalid rows pass
        # through untouched.
        samples, flags, n_samples = stored
    else:
        # Streaming mode: never materialize the (S, B) samples. Sweep the
        # geodesics once storing only K = ceil(S/window) boundary carries,
        # then replay one window at a time in reverse segment order
        # (bit-identical re-integration; ops/geodesic.segment_carries).
        starts, flags, n_samples = geodesic.segment_carries(
            positions, directions, params, window)

    spin, mass, flat = params.bh_a, params.bh_m, params.ray_flat
    bf = b * f

    def _ex(x):
        """Expand a per-ray (B,) array to the flat (B*F,) layout (row-major
        over (ray, frequency), matching (B, F).reshape(-1))."""
        if f == 1:
            return x
        return jnp.repeat(x, f, total_repeat_length=bf)

    # The coherency tensor N is Hermitian and all rotation coefficients
    # (connection contractions, tetrads) are REAL, so N is carried as 10
    # symmetric-real + 6 antisymmetric-imaginary components, each a flat
    # (B*F,) array (see _SYM/_ANT above): real arithmetic needs no
    # complex type, and (B, F, 4, 4) trailing dims would waste most of
    # each vector of work.
    zeros_bf = tuple(jnp.zeros(bf, dtype) for _ in range(10))
    zeros_bf6 = tuple(jnp.zeros(bf, dtype) for _ in range(6))
    zero_b = jnp.zeros(b, dtype)
    state = {
        # Only the post-coupling tensor is carried; the second-half
        # transport of each sample is DEFERRED to the next processed
        # (nearer-to-camera) sample, where delta_lambda_new is the current
        # step (polarized.cpp:121-124) - so the scan needs no
        # next-sample lookahead and samples can be streamed.
        "nn_temp_re": zeros_bf,
        "nn_temp_im": zeros_bf6,
        "coeff_bad": jnp.zeros((b, f), dtype=bool),
        # Previously processed (farther) valid sample: its position /
        # momentum / step, its transport matrix A(pos, k) for the deferred
        # second half, and its contravariant k for the averaged first-half
        # matrix. pos_pv initializes to the (benign, far-from-horizon)
        # camera position so unmasked matrix algebra stays finite.
        "started": jnp.zeros(b, dtype=bool),
        "pos_pv": positions,
        "dl_pv": zero_b,
        "kcon_pv": jnp.zeros((b, 4), dtype),
        "a_prev": tuple(tuple(zero_b for _ in range(4)) for _ in range(4)),
    }
    if opts.time:
        state["time"] = jnp.zeros(b, dtype)
    if opts.length:
        state["length"] = jnp.zeros(b, dtype)
    if opts.lam:
        state["lambda"] = jnp.zeros((b, f), dtype)
    if opts.emission:
        state["emission"] = jnp.zeros((b, f), dtype)
    if opts.tau:
        state["tau"] = jnp.zeros((b, f), dtype)
    if opts.crossings:
        state["crossings"] = jnp.zeros(b, jnp.int32)
        state["plane_sign"] = jnp.zeros(b, dtype=bool)
    if opts.lambda_ave:
        state["lambda_ave"] = jnp.zeros((b, f, NUM_CELL_VALUES), dtype)
        state["lambda_tot"] = jnp.zeros((b, f), dtype)
    if opts.emission_ave:
        state["emission_ave"] = jnp.zeros((b, f, NUM_CELL_VALUES), dtype)
        state["emission_tot"] = jnp.zeros((b, f), dtype)
    if opts.tau_int:
        state["tau_int"] = jnp.zeros((b, f, NUM_CELL_VALUES), dtype)
    if opts.track_sample_times:
        state["t_min"] = jnp.full(b, jnp.inf, dtype)
        state["t_max"] = jnp.full(b, -jnp.inf, dtype)

    def body(state, xs):
        pos, kcov, dl_cur, valid, prims = xs
        coeff_extra = {} if prims is None else {"prims": prims}
        active = valid
        started = state["started"]
        first = active & ~started
        pos_pv = state["pos_pv"]
        dl_pv = state["dl_pv"]
        kcon_prev = state["kcon_pv"]

        dl_cgs = dl_cur[:, None] * x_unit / (frequencies[None, :]
                                             * momentum_factors[:, None])

        # Transport matrices A^m_b = k^a Gamma^m_{ab} in closed scalar form
        # (ops/connection.transport_matrix_c) - never materializing the
        # (B, 4, 4, 4) Christoffel tensor. The averaged first-half matrix
        # kcon_old . conn_old expands by bilinearity:
        #   0.5 (A(prev, k_old) + A(cur, k_old))
        #     = 0.5 A(prev, k_old) + 0.25 A(cur, k_prev) + 0.25 A(cur, k)
        kcon = _kcon_scalar(pos, kcov, spin, mass, flat)
        kcon_old = jnp.where(first[:, None], kcon,
                             0.5 * (kcon_prev + kcon))
        if flat:
            derivs_cur = None
        else:
            derivs_cur = geometry.ks_derivatives_c(
                pos[:, 1], pos[:, 2], pos[:, 3], spin, mass)
        a_cur_k = connection_mod.transport_matrix_c(
            pos[:, 1], pos[:, 2], pos[:, 3],
            kcon[:, 0], kcon[:, 1], kcon[:, 2], kcon[:, 3],
            spin, mass, flat=flat, derivs=derivs_cur)
        a_cur_kprev = connection_mod.transport_matrix_c(
            pos[:, 1], pos[:, 2], pos[:, 3],
            kcon_prev[:, 0], kcon_prev[:, 1], kcon_prev[:, 2],
            kcon_prev[:, 3], spin, mass, flat=flat, derivs=derivs_cur)
        a_prev_kold = connection_mod.transport_matrix_c(
            pos_pv[:, 1], pos_pv[:, 2], pos_pv[:, 3],
            kcon_old[:, 0], kcon_old[:, 1], kcon_old[:, 2], kcon_old[:, 3],
            spin, mass, flat=flat)
        a_half = [[jnp.where(first, a_cur_k[m][bb],
                             0.5 * a_prev_kold[m][bb]
                             + 0.25 * a_cur_kprev[m][bb]
                             + 0.25 * a_cur_k[m][bb])
                   for bb in range(4)] for m in range(4)]

        # Deferred second-half transport of the PREVIOUS processed sample
        # (polarized.cpp:815-833): its delta_lambda_new is THIS sample's
        # step, so it runs here with the carried matrix A(pos_pv, k_pv).
        # Before any sample (first rows), a_prev and nn_temp are zero and
        # the transport is the zero tensor.
        a_prev_bf = [[_ex(state["a_prev"][m][bb]) for bb in range(4)]
                     for m in range(4)]
        dl_local2 = _ex(0.25 * (dl_pv + dl_cur))
        nn_sec_re, nn_sec_im = _transport_c(
            a_prev_bf, state["nn_temp_re"], state["nn_temp_im"],
            state["nn_temp_re"], state["nn_temp_im"], dl_local2)

        # First-half parallel transport (polarized.cpp:174-192) on flat
        # (B*F,) component arrays
        a_half_bf = [[_ex(a_half[m][bb]) for bb in range(4)]
                     for m in range(4)]
        dl_local = _ex(0.5 * (jnp.where(first, 0.0, dl_pv) + dl_cur))
        nn_half_re, nn_half_im = _transport_c(
            a_half_bf, nn_sec_re, nn_sec_im,
            state["nn_temp_re"], state["nn_temp_im"], dl_local)

        # Fluid state, coefficients, tetrad
        coeffs = coeff_fn(pos, kcov, **coeff_extra)
        ucon = coeffs["ucon"]
        bcon = coeffs["bcon"]
        b_zero = coeffs["b_zero"]
        if "bad" in coeffs:
            # Samples the reference would NaN carry finite placeholders +
            # a flag; poison those pixels at the end instead of letting
            # NaN primals destroy reverse-mode (see unpolarized.py)
            state["coeff_bad"] = state["coeff_bad"] | (
                active[:, None] & coeffs["bad"])

        # Fluid tetrad rows in scalarized rank-1 Kerr-Schild form
        # (ops/tetrad.tetrad_rows_c): no (B, 4, 4) metric/tetrad tensors
        # in the hot loop
        if flat:
            f_ks = jnp.zeros_like(pos[:, 0])
            l_ks = (f_ks, f_ks, f_ks)
        else:
            _, f_ks, l_ks, _, _ = derivs_cur
        upcon_c = tuple(
            jnp.where(b_zero, 1.0 if m == 3 else 0.0, bcon[:, m])
            for m in range(4))
        t1c, t2c, e1_cov, e2_cov = tetrad_rows_c(
            tuple(ucon[:, m] for m in range(4)),
            tuple(kcon[:, m] for m in range(4)),
            tuple(kcov[:, m] for m in range(4)),
            upcon_c, f_ks, l_ks)

        # N -> tetrad-frame Stokes (polarized.cpp:264-292): only the
        # (1,2)x(1,2) tetrad block feeds the Stokes vector, so only the
        # two covariant tetrad rows e1/e2 are formed (as flat scalars)
        e1 = [_ex(c) for c in e1_cov]
        e2 = [_ex(c) for c in e2_cov]
        ss_i, ss_q, ss_u, ss_v = _stokes_from_n(e1, e2, nn_half_re,
                                                nn_half_im)

        # Auxiliary image planes (same accumulations as unpolarized)
        if opts.time:
            t_cgs = pos[:, 0] * t_unit
            state["time"] = jnp.where(active,
                                      jnp.minimum(state["time"], t_cgs),
                                      state["time"])
        if opts.length:
            g_cov, g_con = geometry.gcov_gcon(pos[:, 1:4], spin, mass,
                                              flat=flat)
            q = (jnp.einsum("Bam,Bm->Ba", g_con[:, 1:, :], kcov,
                            precision=HIGHEST)
                 - g_con[:, 0, 1:] * (jnp.einsum("Bm,Bm->B", g_con[:, 0, :],
                                                 kcov, precision=HIGHEST)
                                      / g_con[:, 0, 0])[:, None])
            dl2 = jnp.einsum("Bab,Ba,Bb->B", g_cov[:, 1:, 1:], q, q,
                             precision=HIGHEST)
            # sqrt through a double-where: parked rays reach dl2 == 0
            # exactly, where sqrt's VJP is 0 * inf = NaN even under the
            # masking where.
            dl2_pos = dl2 > 0.0
            dl_root = jnp.where(dl2_pos,
                                jnp.sqrt(jnp.where(dl2_pos, dl2, 1.0)), 0.0)
            state["length"] = state["length"] + jnp.where(
                active, dl_root * dl_cur * x_unit, 0.0)
        if opts.lam:
            state["lambda"] = state["lambda"] + jnp.where(
                active[:, None], dl_cgs, 0.0)
        if opts.emission:
            state["emission"] = state["emission"] + jnp.where(
                active[:, None], coeffs["j_i"] * dl_cgs, 0.0)
        if opts.tau:
            state["tau"] = state["tau"] + jnp.where(
                active[:, None], coeffs["alpha_i"] * dl_cgs, 0.0)
        if opts.crossings:
            sign_new = (camera_x[1] * pos[:, 1] + camera_x[2] * pos[:, 2]
                        + camera_x[3] * pos[:, 3]) > 0.0
            flipped = active & started & (sign_new != state["plane_sign"])
            state["crossings"] = state["crossings"] + flipped.astype(jnp.int32)
            state["plane_sign"] = jnp.where(active, sign_new,
                                            state["plane_sign"])

        if opts.track_sample_times:
            t = pos[:, 0]
            state["t_min"] = jnp.where(active,
                                       jnp.minimum(state["t_min"], t),
                                       state["t_min"])
            state["t_max"] = jnp.where(active,
                                       jnp.maximum(state["t_max"], t),
                                       state["t_max"])

        # Cell-value-weighted images (polarized.cpp:338-371); the scan
        # already runs far -> camera, so the tau_int recurrence applies
        # directly
        if need_cells:
            cells = cell_fn(pos, kcov, **coeff_extra)
            cells_ok = active[:, None] & ~jnp.isnan(cells[:, 0:1])
            cells = jnp.where(jnp.isnan(cells), 0.0, cells)
        if opts.lambda_ave:
            state["lambda_tot"] = state["lambda_tot"] + jnp.where(
                active[:, None], dl_cgs, 0.0)
            upd = jnp.where(cells_ok[:, :, None],
                            cells[:, None, :] * dl_cgs[..., None], 0.0)
            state["lambda_ave"] = state["lambda_ave"] + upd
        if opts.emission_ave:
            w = coeffs["j_i"] * dl_cgs
            state["emission_tot"] = state["emission_tot"] + jnp.where(
                active[:, None], w, 0.0)
            upd = jnp.where(cells_ok[:, :, None],
                            cells[:, None, :] * w[..., None], 0.0)
            state["emission_ave"] = state["emission_ave"] + upd
        if opts.tau_int:
            delta_tau = coeffs["alpha_i"] * dl_cgs
            thin = delta_tau <= DELTA_TAU_MAX
            # exp(-dt)*(old + cells*expm1(dt)) rewritten overflow-free:
            # exp(-dt)*old + cells*(1 - exp(-dt))
            exp_neg = jnp.exp(-delta_tau)
            new_thin = exp_neg[..., None] * state["tau_int"] \
                + cells[:, None, :] * (1.0 - exp_neg)[..., None]
            new_thick = jnp.broadcast_to(cells[:, None, :],
                                         state["tau_int"].shape)
            new = jnp.where(thin[..., None], new_thin, new_thick)
            state["tau_int"] = jnp.where(cells_ok[:, :, None], new,
                                         state["tau_int"])

        # Matter coupling in the tetrad frame, per flat component
        dl_flat = dl_cgs.reshape(bf)
        ss_end = couple_matter_c(
            ss_i, ss_q, ss_u, ss_v,
            coeffs["j_i"].reshape(bf), coeffs["j_q"].reshape(bf),
            coeffs["j_v"].reshape(bf),
            coeffs["alpha_i"].reshape(bf), coeffs["alpha_q"].reshape(bf),
            coeffs["alpha_v"].reshape(bf),
            coeffs["rho_q"].reshape(bf), coeffs["rho_v"].reshape(bf),
            dl_flat, rotation_split)

        # Stokes -> N (I 13; polarized.cpp:793-813): the tetrad-frame N is
        # nonzero only in the 2x2 transverse block, reconstructed from the
        # two contravariant tetrad rows. The second-half transport of THIS
        # sample is deferred to the next processed sample (or the final
        # camera-end transport after the scan).
        t1 = [_ex(c) for c in t1c]
        t2 = [_ex(c) for c in t2c]
        nn_post_re, nn_post_im = _n_from_stokes(t1, t2, *ss_end)

        af = _ex(active)
        state["nn_temp_re"] = tuple(jnp.where(af, n, o) for n, o in
                                    zip(nn_post_re, state["nn_temp_re"]))
        state["nn_temp_im"] = tuple(jnp.where(af, n, o) for n, o in
                                    zip(nn_post_im, state["nn_temp_im"]))
        state["a_prev"] = tuple(
            tuple(jnp.where(active, a_cur_k[m][bb], state["a_prev"][m][bb])
                  for bb in range(4)) for m in range(4))
        state["kcon_pv"] = jnp.where(active[:, None], kcon, state["kcon_pv"])
        state["pos_pv"] = jnp.where(active[:, None], pos, state["pos_pv"])
        state["dl_pv"] = jnp.where(active, dl_cur, state["dl_pv"])
        state["started"] = started | active
        return state, None

    # Rematerialize the body in reverse-mode (same policy as the geodesic
    # scan, ops/geodesic.py): backward recomputes each step from its xs
    # instead of storing every per-step intermediate for all S steps.
    if stored is not None:
        xs = (samples.pos, samples.dir, -samples.len, samples.valid,
              stored_prims)
        state, _ = jax.lax.scan(jax.checkpoint(body), state, xs,
                                reverse=True)
    else:
        n_seg = -(-params.ray_max_steps // window)

        def seg_body(st, seg):
            k, start = seg
            s_k = geodesic.replay_window(start, params, k, window)
            xs_k = (s_k.pos, s_k.dir, -s_k.len, s_k.valid, None)
            st, _ = jax.lax.scan(jax.checkpoint(body), st, xs_k,
                                 reverse=True)
            return st, None

        # Outer checkpoint: backward re-runs one window's replay + scan at
        # a time, so gradient memory is O(K + window), never O(S).
        state, _ = jax.lax.scan(jax.checkpoint(seg_body), state,
                                (jnp.arange(n_seg), starts), reverse=True)

    # Final deferred second-half transport at the camera end: the nearest
    # processed sample's delta_lambda_new is its own step
    # (polarized.cpp:121-124), so dl = 0.25 (dl_pv + dl_pv).
    a_prev_bf = [[_ex(state["a_prev"][m][bb]) for bb in range(4)]
                 for m in range(4)]
    nn_fin_re, nn_fin_im = _transport_c(
        a_prev_bf, state["nn_temp_re"], state["nn_temp_im"],
        state["nn_temp_re"], state["nn_temp_im"], _ex(0.5 * state["dl_pv"]))

    # Camera-frame Stokes extraction (polarized.cpp:846-949)
    stokes_i, stokes_q, stokes_u, stokes_v = camera_stokes(
        nn_fin_re, nn_fin_im, positions, directions, spin, mass, flat,
        frequencies, camera_u_con, camera_u_cov, camera_vert_con_c,
        log_j_scale)

    nan = jnp.array(jnp.nan, dtype)
    poison = (flags & opts.fallback_nan)[:, None] | state["coeff_bad"]
    out = {
        "_flags": flags, "_n_samples": n_samples,
        "I_nu": jnp.where(poison, nan, stokes_i),
        "Q_nu": jnp.where(poison, nan, stokes_q),
        "U_nu": jnp.where(poison, nan, stokes_u),
        "V_nu": jnp.where(poison, nan, stokes_v),
    }
    if opts.time:
        out["time"] = state["time"]
    if opts.length:
        out["length"] = state["length"]
    if opts.lam:
        out["lambda"] = state["lambda"]
    if opts.emission:
        out["emission"] = jnp.where(
            poison, nan, state["emission"] * jnp.exp(jnp.asarray(log_j_scale, dtype)))
    if opts.tau:
        out["tau"] = jnp.where(poison, nan, state["tau"])
    if opts.lambda_ave:
        ave = state["lambda_ave"] / state["lambda_tot"][..., None]
        out["lambda_ave"] = jnp.where(poison[..., None], 0.0, ave)
    if opts.emission_ave:
        ave = state["emission_ave"] / state["emission_tot"][..., None]
        out["emission_ave"] = jnp.where(poison[..., None], nan, ave)
    if opts.tau_int:
        out["tau_int"] = jnp.where(poison[..., None], nan, state["tau_int"])
    if opts.crossings:
        out["crossings"] = state["crossings"].astype(dtype)
    if opts.track_sample_times:
        out["_t_min"] = state["t_min"]
        out["_t_max"] = state["t_max"]
    return out
