"""Matter-coupling operators for polarized transfer (Stokes space).

Exact batched transcription of the coupling regimes in the reference
(src/radiation_integrator/polarized.cpp:380-790), following ipole
(2018 MNRAS 475 43, I) and 1985 SoPh 97 239 (L):

- free emission (no absorption, no rotation)
- unpolarized absorption (exponential update)
- pure rotation (I A2-A5)
- polarized absorption without rotation (I A14-A17)
- full absorption+rotation via the M1-M4 matrix polynomials (L 10, I 24)
- optically thick saturation in every regime
- physical admissibility clamp sqrt(Q^2+U^2+V^2) <= I

The reference's M2/M3/M4 matrices are reproduced exactly as written there
(including elements the original leaves at zero), since the goldens are
generated by that code. All conditional regimes become jnp.where ladders
with sanitized divisors so gradients stay finite.

Shapes: Stokes vectors are (..., 4); coefficient dicts hold (...,) arrays
j_i/j_q/j_v, alpha_i/alpha_q/alpha_v, rho_q/rho_v.
"""

from __future__ import annotations

import jax.numpy as jnp

from blacklight.constants import HIGHEST

DELTA_TAU_MAX = 100.0


def _safe_div(num, den, fallback=1.0):
    ok = den != 0.0
    return num / jnp.where(ok, den, fallback), ok


def admissibility_clamp(ss):
    """max(I,0); scale (Q,U,V) into the physical cone
    (polarized.cpp:457-466, 781-790)."""
    s0 = jnp.maximum(ss[..., 0], 0.0)
    pol = ss[..., 1] ** 2 + ss[..., 2] ** 2 + ss[..., 3] ** 2
    need = pol > s0 * s0
    factor = jnp.where(need,
                       jnp.sqrt(s0 * s0 / jnp.where(need, pol, 1.0)),
                       1.0)
    return jnp.concatenate([s0[..., None], ss[..., 1:] * factor[..., None]],
                           axis=-1)


def _rotate(ss, rho1, rho3, rho_p, rho_sq, dl):
    """Faraday rotation operator (I A2-A5; polarized.cpp:500-514)."""
    cos_rho = jnp.cos(rho_p * dl)
    sin_rho = jnp.sin(rho_p * dl)
    sin_sq_rho = jnp.sin(rho_p * dl / 2.0) ** 2
    rho_safe, _ = _safe_div(1.0, rho_p)
    rho_sq_safe, _ = _safe_div(1.0, rho_sq)
    rho_ss = rho1 * ss[..., 1] + rho3 * ss[..., 3]
    s0 = ss[..., 0]
    s1 = (ss[..., 1] * cos_rho + 2.0 * rho1 * rho_ss * rho_sq_safe * sin_sq_rho
          - rho3 * ss[..., 2] * rho_safe * sin_rho)
    s2 = (ss[..., 2] * cos_rho
          + (rho3 * ss[..., 1] - rho1 * ss[..., 3]) * rho_safe * sin_rho)
    s3 = (ss[..., 3] * cos_rho + 2.0 * rho3 * rho_ss * rho_sq_safe * sin_sq_rho
          + rho1 * ss[..., 2] * rho_safe * sin_rho)
    return jnp.stack([s0, s1, s2, s3], axis=-1)


def _couple_absorption(ss, j, a1, a3, a_i, alpha_p, alpha_sq, dl, thin):
    """Polarized absorption without rotation (I A14-A17;
    polarized.cpp:414-456 and 617-657), for step length dl.

    Returns the thin-case and thick-case results (each (..., 4))."""
    tau = a_i * dl
    exp_neg_i = jnp.exp(-tau)
    ap_dl = alpha_p * dl
    exp_neg_p = jnp.exp(-ap_dl)
    sinh_p = jnp.sinh(ap_dl)
    cosh_p = jnp.cosh(ap_dl)
    coshm1_p = 0.5 * (jnp.expm1(ap_dl) + exp_neg_p - 1.0)
    alpha_ss = a1 * ss[..., 1] + a3 * ss[..., 3]
    alpha_j = a1 * j[..., 1] + a3 * j[..., 3]
    inv_ai, _ = _safe_div(1.0, a_i)
    inv_ap, _ = _safe_div(1.0, alpha_p)
    inv_asq, _ = _safe_div(1.0, alpha_sq)
    fac, _ = _safe_div(1.0, a_i * a_i - alpha_sq)

    s0_thin = ((ss[..., 0] * cosh_p - alpha_ss * inv_ap * sinh_p) * exp_neg_i
               + alpha_j * fac * (-1.0 + (a_i * sinh_p + alpha_p * cosh_p)
                                  * inv_ap * exp_neg_p)
               + a_i * j[..., 0] * fac * (1.0 - (a_i * cosh_p + alpha_p * sinh_p)
                                          * inv_ai * exp_neg_p))
    thin_rest = []
    alpha_s = (jnp.zeros_like(a1), a1, jnp.zeros_like(a1), a3)
    for a in (1, 2, 3):
        aa = alpha_s[a]
        term_1 = (ss[..., a] + aa * alpha_ss * inv_asq * coshm1_p
                  - ss[..., 0] * aa * inv_ap * sinh_p) * exp_neg_i
        term_2 = j[..., a] * (1.0 - exp_neg_i) * inv_ai
        term_3 = alpha_j * aa * inv_ai * fac * (
            1.0 - (1.0 - a_i * a_i * inv_asq
                   - a_i * inv_asq * (a_i * cosh_p + alpha_p * sinh_p)) * exp_neg_i)
        term_4 = j[..., 0] * aa * inv_ap * fac * (
            -alpha_p + (alpha_p * cosh_p + a_i * sinh_p) * exp_neg_i)
        thin_rest.append(term_1 + term_2 + term_3 + term_4)
    ss_thin = jnp.stack([s0_thin] + thin_rest, axis=-1)

    s0_thick = (a_i * j[..., 0] - alpha_j) * fac
    thick_rest = [(j[..., a] - alpha_s[a] * s0_thick) * inv_ai for a in (1, 2, 3)]
    ss_thick = jnp.stack([s0_thick] + thick_rest, axis=-1)
    return jnp.where(thin[..., None], ss_thin, ss_thick)


def _couple_simple(ss, j, a_i, dl, thin):
    """Unpolarized absorption on all components (polarized.cpp:402-412)."""
    tau = a_i * dl
    inv_ai, _ = _safe_div(1.0, a_i)
    exp_neg = jnp.exp(-tau)
    expm1 = jnp.expm1(tau)
    thin_res = exp_neg[..., None] * (ss + j * (inv_ai * expm1)[..., None])
    thick_res = j * inv_ai[..., None]
    return jnp.where(thin[..., None], thin_res, thick_res)


def _couple_matrix(ss, j, a1, a3, a_i, alpha_sq, rho1, rho3, rho_sq, dl, thin):
    """Full absorption+rotation matrix exponential (L 10, I 24;
    polarized.cpp:660-779), matrices exactly as the reference writes them."""
    alpha_rho = a1 * rho1 + a3 * rho3
    asr = alpha_sq - rho_sq
    lambda_a = jnp.sqrt(asr * asr / 4.0 + alpha_rho * alpha_rho)
    lambda_b = asr / 2.0
    lam1 = jnp.sqrt(jnp.maximum(lambda_a + lambda_b, 0.0))
    lam2 = jnp.sqrt(jnp.maximum(lambda_a - lambda_b, 0.0))
    ctheta = lam1 * lam1 + lam2 * lam2
    inv_ct, _ = _safe_div(1.0, ctheta)
    s = jnp.where(alpha_rho >= 0.0, 1.0, -1.0)

    zero = jnp.zeros_like(a_i)

    def mat(rows):
        return jnp.stack([jnp.stack(r, axis=-1) for r in rows], axis=-2)

    # M2 (polarized.cpp:676-696 as written: [1][2] is assigned twice and the
    # second assignment wins; [0][2], [1][3], [2][3] stay zero)
    m2_01 = (lam2 * a1 - s * lam1 * rho1) * inv_ct
    m2_03 = (lam2 * a3 - s * lam1 * rho3) * inv_ct
    m2_12 = (s * lam1 * a1 + lam2 * rho1) * inv_ct
    mm2 = mat([
        [zero, m2_01, zero, m2_03],
        [m2_01, zero, m2_12, zero],
        [zero, -m2_12, zero, zero],
        [m2_03, zero, zero, zero],
    ])

    # M3 (polarized.cpp:698-718, same as-written quirks)
    m3_01 = (lam1 * a1 + s * lam2 * rho1) * inv_ct
    m3_03 = (lam1 * a3 + s * lam2 * rho3) * inv_ct
    m3_12 = -(s * lam2 * a1 - lam1 * rho1) * inv_ct
    mm3 = mat([
        [zero, m3_01, zero, m3_03],
        [m3_01, zero, m3_12, zero],
        [zero, -m3_12, zero, zero],
        [m3_03, zero, zero, zero],
    ])

    # M4 (polarized.cpp:720-742; [0][1], [0][3], [1][2], [2][3] stay zero)
    half_sum = (alpha_sq + rho_sq) / 2.0
    m4_00 = half_sum * 2.0 * inv_ct
    m4_11 = (a1 * a1 + rho1 * rho1 - half_sum) * 2.0 * inv_ct
    m4_22 = -half_sum * 2.0 * inv_ct
    m4_33 = (a3 * a3 + rho3 * rho3 - half_sum) * 2.0 * inv_ct
    m4_02 = (a1 * rho3 - a3 * rho1) * 2.0 * inv_ct
    m4_13 = (a3 * a1 + rho3 * rho1) * 2.0 * inv_ct
    mm4 = mat([
        [m4_00, zero, m4_02, zero],
        [zero, m4_11, zero, m4_13],
        [-m4_02, zero, m4_22, zero],
        [zero, m4_13, zero, m4_33],
    ])
    eye = jnp.broadcast_to(jnp.eye(4, dtype=a_i.dtype), mm4.shape)

    tau = a_i * dl
    exp_t = jnp.exp(-tau)
    sin_t = jnp.sin(lam2 * dl)
    cos_t = jnp.cos(lam2 * dl)
    sinh_t = jnp.sinh(lam1 * dl)
    cosh_t = jnp.cosh(lam1 * dl)

    def bc(v):
        return v[..., None, None]

    oo = bc(exp_t) * (0.5 * (eye + mm4) * bc(cosh_t)
                      + 0.5 * (eye - mm4) * bc(cos_t)
                      - mm2 * bc(sin_t) - mm3 * bc(sinh_t))

    f_1, _ = _safe_div(1.0, a_i * a_i - lam1 * lam1)
    f_2, _ = _safe_div(1.0, a_i * a_i + lam2 * lam2)
    cosh_term = -bc(lam1 * f_1) * mm3 + 0.5 * bc(a_i * f_1) * (eye + mm4)
    cos_term = -bc(lam2 * f_2) * mm2 + 0.5 * bc(a_i * f_2) * (eye - mm4)
    pp = cosh_term + cos_term
    sin_term = -bc(a_i * f_2) * mm2 - 0.5 * bc(lam2 * f_2) * (eye - mm4)
    sinh_term = -bc(a_i * f_1) * mm3 + 0.5 * bc(lam1 * f_1) * (eye + mm4)
    pp_thin = pp - bc(exp_t) * (cosh_term * bc(cosh_t) + cos_term * bc(cos_t)
                                + sin_term * bc(sin_t) + sinh_term * bc(sinh_t))
    pp = jnp.where(thin[..., None, None], pp_thin, pp)

    out = jnp.einsum("...ab,...b->...a", pp, j, precision=HIGHEST)
    out_thin = out + jnp.einsum("...ab,...b->...a", oo, ss, precision=HIGHEST)
    return jnp.where(thin[..., None], out_thin, out)


# ---------------------------------------------------------------------------
# Component (scalarized) forms - the hot path.
#
# The stacked (..., 4) / (..., 4, 4) forms above put tiny Stokes/Mueller
# dims in trailing positions and emit hundreds of small ops per step.
# These forms carry each Stokes component as its own flat array
# (components in Python, batch on the one axis), so the whole coupling
# fuses into a few full-width elementwise loops - the same scalarization
# as the Kerr-Schild geodesic hot path (ops/geometry.ks_derivatives_c).
# Same math as the stacked forms (tested one-to-one in
# tests/test_polarized_scalar.py).
# ---------------------------------------------------------------------------


# sqrt floor so d sqrt never becomes inf at an exact zero (the value is
# indistinguishable from 0 downstream). Overflow clamp for hyperbolic
# arguments evaluated in unselected branches: cosh(705) is the largest
# finite float64. Reciprocal guard so 1/den's VJP intermediate den^-2
# stays finite. All three are dtype-dependent: float32 overflows at 3e38,
# so its floors must sit near 1e-16 (den^-2 <= 1e32) and its exp cap at
# 80 (cosh(80) ~ 2.7e34) - values that only make sense because
# couple_matter_c first rescales its inputs to per-step optical-depth
# units (tau = alpha dl, O(1)), where anything below 1e-16 is a
# physically-zero contribution. In float64 the floors keep their
# original near-denormal values, so forward behavior there is unchanged.
_SQRT_FLOOR = 1e-40
_EXP_MAX = 705.0

def _lims(x):
    """(sqrt floor, exp cap, recip guard) for x's dtype."""
    if x.dtype == jnp.float64:
        return _SQRT_FLOOR, _EXP_MAX, 0.0
    return 1e-16, 80.0, 1e-16


def _safe_recip(den, fallback=1.0):
    """1/den with |den| <= guard lanes replaced by 1/fallback: den == 0
    exactly (f64) or den too small for the division VJP's den^-2 to stay
    finite (f32; such lanes carry physically-zero contributions in
    optical-depth units - see couple_matter_c's rescale)."""
    tiny = _lims(den)[2]
    ok = jnp.abs(den) > tiny
    return 1.0 / jnp.where(ok, den, fallback)


def admissibility_clamp_c(s0, s1, s2, s3):
    """Component form of :func:`admissibility_clamp`.

    sqrt(s0^2/pol) is rewritten s0/sqrt(pol): the former's adjoint is
    inf*0 = NaN at s0 == 0 with pol > 0 (a clamped negative intensity),
    the latter's is finite everywhere with the floored sqrt."""
    s0c = jnp.maximum(s0, 0.0)
    pol = s1 * s1 + s2 * s2 + s3 * s3
    need = pol > s0c * s0c
    factor = jnp.where(need,
                       s0c / jnp.sqrt(jnp.maximum(pol, _lims(pol)[0])), 1.0)
    return s0c, s1 * factor, s2 * factor, s3 * factor


def _rotate_c(s0, s1, s2, s3, rho1, rho3, rho_p, rho_sq, dl):
    """Component form of :func:`_rotate` (I A2-A5)."""
    cos_rho = jnp.cos(rho_p * dl)
    sin_rho = jnp.sin(rho_p * dl)
    sin_sq_rho = jnp.sin(rho_p * dl / 2.0) ** 2
    inv_rho = _safe_recip(rho_p)
    inv_rho_sq = _safe_recip(rho_sq)
    rho_ss = rho1 * s1 + rho3 * s3
    r1 = (s1 * cos_rho + 2.0 * rho1 * rho_ss * inv_rho_sq * sin_sq_rho
          - rho3 * s2 * inv_rho * sin_rho)
    r2 = s2 * cos_rho + (rho3 * s1 - rho1 * s3) * inv_rho * sin_rho
    r3 = (s3 * cos_rho + 2.0 * rho3 * rho_ss * inv_rho_sq * sin_sq_rho
          + rho1 * s2 * inv_rho * sin_rho)
    return s0, r1, r2, r3


def _couple_simple_c(s0, s1, s2, s3, j0, j1, j3, a_i, dl, thin):
    """Component form of :func:`_couple_simple` (j2 = 0 structurally).

    The thin branch's j/alpha * expm1(tau) is evaluated as
    j * dl * (expm1(tau)/tau), whose ratio has the smooth limit 1 at
    tau -> 0: the inv_ai form loses the emission of near-transparent
    steps once _safe_recip's float32 guard engages (j stays finite while
    a_i -> 0)."""
    tau = a_i * dl
    inv_ai = _safe_recip(a_i)
    exp_neg = jnp.exp(-tau)
    # expm1 is only consumed when thin (tau <= DELTA_TAU_MAX); clamp so the
    # unselected-thick lane never materializes an inf primal.
    tau_c = jnp.minimum(tau, _lims(tau)[1])
    small = tau_c < 1e-4
    # Cubic Taylor tail: rel err tau^4/120 < 1e-18 at the cutover, below
    # even float64 roundoff - forward parity with the literal form holds.
    em1_over_tau = jnp.where(
        small, 1.0 + tau_c * (0.5 + tau_c * (1.0 / 6.0 + tau_c / 24.0)),
        jnp.expm1(tau_c) / jnp.where(small, 1.0, tau_c))
    edl = em1_over_tau * dl
    r0 = jnp.where(thin, exp_neg * (s0 + j0 * edl), j0 * inv_ai)
    r1 = jnp.where(thin, exp_neg * (s1 + j1 * edl), j1 * inv_ai)
    r2 = jnp.where(thin, exp_neg * s2, 0.0)
    r3 = jnp.where(thin, exp_neg * (s3 + j3 * edl), j3 * inv_ai)
    return r0, r1, r2, r3


def _couple_absorption_c(s0, s1, s2, s3, j0, j1, j3, a1, a3, a_i,
                         alpha_p, alpha_sq, dl, thin):
    """Component form of :func:`_couple_absorption` (I A14-A17).

    alpha_s = (0, a1, 0, a3) and j = (j0, j1, 0, j3), so the a = 2
    component collapses to pure exponential decay."""
    tau = a_i * dl
    exp_neg_i = jnp.exp(-tau)
    ap_dl = jnp.minimum(alpha_p * dl, _lims(tau)[1])
    exp_neg_p = jnp.exp(-ap_dl)
    sinh_p = jnp.sinh(ap_dl)
    cosh_p = jnp.cosh(ap_dl)
    coshm1_p = 0.5 * (jnp.expm1(ap_dl) + exp_neg_p - 1.0)
    alpha_ss = a1 * s1 + a3 * s3
    alpha_j = a1 * j1 + a3 * j3
    inv_ai = _safe_recip(a_i)
    inv_ap = _safe_recip(alpha_p)
    inv_asq = _safe_recip(alpha_sq)
    fac = _safe_recip(a_i * a_i - alpha_sq)
    # (1 - e^-tau)/a_i as dl * (1 - e^-tau)/tau (smooth limit 1): the
    # inv_ai form loses near-transparent steps' emission once the float32
    # recip guard engages. Cubic tail rel err < tau^4/120.
    small = tau < 1e-4
    omexp_over = jnp.where(
        small, 1.0 - tau * (0.5 - tau * (1.0 / 6.0 - tau / 24.0)),
        (1.0 - exp_neg_i) / jnp.where(small, 1.0, tau))
    omexp_dl = omexp_over * dl

    t0_thin = ((s0 * cosh_p - alpha_ss * inv_ap * sinh_p) * exp_neg_i
               + alpha_j * fac * (-1.0 + (a_i * sinh_p + alpha_p * cosh_p)
                                  * inv_ap * exp_neg_p)
               + a_i * j0 * fac * (1.0 - (a_i * cosh_p + alpha_p * sinh_p)
                                   * inv_ai * exp_neg_p))
    t0_thick = (a_i * j0 - alpha_j) * fac

    def rest(aa, jj, ss):
        term_1 = (ss + aa * alpha_ss * inv_asq * coshm1_p
                  - s0 * aa * inv_ap * sinh_p) * exp_neg_i
        term_2 = jj * omexp_dl
        term_3 = alpha_j * aa * inv_ai * fac * (
            1.0 - (1.0 - a_i * a_i * inv_asq
                   - a_i * inv_asq * (a_i * cosh_p + alpha_p * sinh_p))
            * exp_neg_i)
        term_4 = j0 * aa * inv_ap * fac * (
            -alpha_p + (alpha_p * cosh_p + a_i * sinh_p) * exp_neg_i)
        thin_v = term_1 + term_2 + term_3 + term_4
        thick_v = (jj - aa * t0_thick) * inv_ai
        return jnp.where(thin, thin_v, thick_v)

    r0 = jnp.where(thin, t0_thin, t0_thick)
    r1 = rest(a1, j1, s1)
    r2 = jnp.where(thin, s2 * exp_neg_i, 0.0)
    r3 = rest(a3, j3, s3)
    return r0, r1, r2, r3


def _gmatvec(p, q, pm, m4_00, m4_11, m4_22, m4_33, m4_02, m4_13,
             g01, g03, g12, v0, v1, v2, v3):
    """(p*(I+M4) + q*(I-M4) + r*M2 + s*M3) . v with the shared M2/M3
    sparsity folded in: pm = p - q, g0i = r*m2_0i + s*m3_0i,
    g12 = r*m2_12 + s*m3_12 (M2/M3 are symmetric at (0,1)/(0,3) and
    antisymmetric at (1,2))."""
    pq = p + q
    r0 = (pq + pm * m4_00) * v0 + g01 * v1 + pm * m4_02 * v2 + g03 * v3
    r1 = g01 * v0 + (pq + pm * m4_11) * v1 + g12 * v2 + pm * m4_13 * v3
    r2 = -pm * m4_02 * v0 - g12 * v1 + (pq + pm * m4_22) * v2
    r3 = g03 * v0 + pm * m4_13 * v1 + (pq + pm * m4_33) * v3
    return r0, r1, r2, r3


def _couple_matrix_c(s0, s1, s2, s3, j0, j1, j3, a1, a3, a_i, alpha_sq,
                     rho1, rho3, rho_sq, dl, thin):
    """Component form of :func:`_couple_matrix` (L 10, I 24): the M1-M4
    matrices are never materialized; their fixed sparsity is expanded into
    the two matvecs O.ss and P.j via :func:`_gmatvec`.

    Gradient safety: this branch is evaluated for EVERY sample and only
    selected where both absorption and rotation are nonzero, so sqrt
    arguments that are exactly zero elsewhere must be floored (d sqrt(0)
    is inf, and inf adjoints poison reverse-mode through the masking
    where()), and hyperbolic arguments clamped below overflow."""
    alpha_rho = a1 * rho1 + a3 * rho3
    asr = alpha_sq - rho_sq
    floor = _lims(alpha_sq)[0]
    lambda_a = jnp.sqrt(jnp.maximum(asr * asr / 4.0 + alpha_rho * alpha_rho,
                                    floor))
    lambda_b = asr / 2.0
    lam1 = jnp.sqrt(jnp.maximum(lambda_a + lambda_b, floor))
    lam2 = jnp.sqrt(jnp.maximum(lambda_a - lambda_b, floor))
    ctheta = lam1 * lam1 + lam2 * lam2
    inv_ct = _safe_recip(ctheta)
    sgn = jnp.where(alpha_rho >= 0.0, 1.0, -1.0)

    m2_01 = (lam2 * a1 - sgn * lam1 * rho1) * inv_ct
    m2_03 = (lam2 * a3 - sgn * lam1 * rho3) * inv_ct
    m2_12 = (sgn * lam1 * a1 + lam2 * rho1) * inv_ct
    m3_01 = (lam1 * a1 + sgn * lam2 * rho1) * inv_ct
    m3_03 = (lam1 * a3 + sgn * lam2 * rho3) * inv_ct
    m3_12 = -(sgn * lam2 * a1 - lam1 * rho1) * inv_ct
    half_sum = (alpha_sq + rho_sq) / 2.0
    m4_00 = half_sum * 2.0 * inv_ct
    m4_11 = (a1 * a1 + rho1 * rho1 - half_sum) * 2.0 * inv_ct
    m4_22 = -half_sum * 2.0 * inv_ct
    m4_33 = (a3 * a3 + rho3 * rho3 - half_sum) * 2.0 * inv_ct
    m4_02 = (a1 * rho3 - a3 * rho1) * 2.0 * inv_ct
    m4_13 = (a3 * a1 + rho3 * rho1) * 2.0 * inv_ct

    tau = a_i * dl
    exp_t = jnp.exp(-tau)
    lam1_dl = jnp.minimum(lam1 * dl, _lims(lam1)[1])
    sin_t = jnp.sin(lam2 * dl)
    cos_t = jnp.cos(lam2 * dl)
    sinh_t = jnp.sinh(lam1_dl)
    cosh_t = jnp.cosh(lam1_dl)

    def gv(p, q, r, s, v0, v1, v2, v3):
        return _gmatvec(p, q, p - q, m4_00, m4_11, m4_22, m4_33, m4_02,
                        m4_13, r * m2_01 + s * m3_01, r * m2_03 + s * m3_03,
                        r * m2_12 + s * m3_12, v0, v1, v2, v3)

    # O.ss = exp(-tau) (1/2(I+M4)cosh + 1/2(I-M4)cos - M2 sin - M3 sinh).ss
    o0, o1, o2, o3 = gv(0.5 * cosh_t, 0.5 * cos_t, -sin_t, -sinh_t,
                        s0, s1, s2, s3)

    f_1 = _safe_recip(a_i * a_i - lam1 * lam1)
    f_2 = _safe_recip(a_i * a_i + lam2 * lam2)
    zero = jnp.zeros_like(j0)
    # P = cosh_term + cos_term with cosh_term = -lam1 f1 M3 + a_i f1/2 (I+M4)
    # and cos_term = -lam2 f2 M2 + a_i f2/2 (I-M4)
    p0, p1, p2, p3 = gv(0.5 * a_i * f_1, 0.5 * a_i * f_2,
                        -lam2 * f_2, -lam1 * f_1, j0, j1, zero, j3)
    # thin correction: exp(-tau) (cosh_term cosh + cos_term cos
    #                             + sin_term sin + sinh_term sinh) with
    # sin_term = -a_i f2 M2 - lam2 f2/2 (I-M4),
    # sinh_term = -a_i f1 M3 + lam1 f1/2 (I+M4)
    c0, c1, c2, c3 = gv(
        f_1 * 0.5 * (a_i * cosh_t + lam1 * sinh_t),
        f_2 * 0.5 * (a_i * cos_t - lam2 * sin_t),
        f_2 * (-lam2 * cos_t - a_i * sin_t),
        f_1 * (-lam1 * cosh_t - a_i * sinh_t),
        j0, j1, zero, j3)

    r0 = jnp.where(thin, p0 - exp_t * c0 + exp_t * o0, p0)
    r1 = jnp.where(thin, p1 - exp_t * c1 + exp_t * o1, p1)
    r2 = jnp.where(thin, p2 - exp_t * c2 + exp_t * o2, p2)
    r3 = jnp.where(thin, p3 - exp_t * c3 + exp_t * o3, p3)
    return r0, r1, r2, r3


def couple_matter_c(s0, s1, s2, s3, j0, j1, j3, a_i, a1, a3, rho1, rho3,
                    dl_cgs, rotation_split: bool):
    """Component form of :func:`couple_matter`: one matter-coupling step on
    flat per-component Stokes arrays. Returns (s0, s1, s2, s3).

    The coupling algebra is invariant under (j, alpha, rho) -> dl * (j,
    alpha, rho), dl -> 1 (every term pairs a coefficient with dl or with
    another coefficient's reciprocal), so the inputs are first rescaled to
    per-step optical-depth units: CGS alphas are ~1/dl_cgs ~ 1e-15 and
    their squares underflow-adjacent in float32, while taus are O(1),
    which is what makes the float32 floors in _lims sound."""
    one = jnp.ones_like(dl_cgs)
    j0, j1, j3 = j0 * dl_cgs, j1 * dl_cgs, j3 * dl_cgs
    a_i, a1, a3 = a_i * dl_cgs, a1 * dl_cgs, a3 * dl_cgs
    rho1, rho3 = rho1 * dl_cgs, rho3 * dl_cgs
    dl_cgs = one
    alpha_sq = a1 * a1 + a3 * a3
    rho_sq = rho1 * rho1 + rho3 * rho3
    # Regime tests on the exact squared sums; the roots get the gradient
    # floor (see _lims note) since they are evaluated for every sample
    # but only selected in their own regimes.
    a0_zero = a_i == 0.0
    ap_zero = alpha_sq == 0.0
    rp_zero = rho_sq == 0.0
    floor = _lims(alpha_sq)[0]
    alpha_p = jnp.sqrt(jnp.maximum(alpha_sq, floor))
    rho_p = jnp.sqrt(jnp.maximum(rho_sq, floor))
    delta_tau = a_i * dl_cgs
    thin = delta_tau <= DELTA_TAU_MAX

    def sel(cond, a, b):
        return tuple(jnp.where(cond, x, y) for x, y in zip(a, b))

    if rotation_split:
        def half_couple(ss):
            half = dl_cgs / 2.0
            r_free = (ss[0] + j0 * half, ss[1] + j1 * half,
                      ss[2], ss[3] + j3 * half)
            r_simple = _couple_simple_c(*ss, j0, j1, j3, a_i, half, thin)
            r_abs = _couple_absorption_c(*ss, j0, j1, j3, a1, a3, a_i,
                                         alpha_p, alpha_sq, half, thin)
            res = sel(a0_zero, r_free, sel(ap_zero, r_simple, r_abs))
            return admissibility_clamp_c(*res)

        ss = half_couple((s0, s1, s2, s3))
        rotated = _rotate_c(*ss, rho1, rho3, rho_p, rho_sq, dl_cgs)
        ss = sel(rp_zero, ss, rotated)
        ss = admissibility_clamp_c(*ss)
        ss = half_couple(ss)
        return admissibility_clamp_c(*ss)

    ss = (s0, s1, s2, s3)
    r1_ = (s0 + j0 * dl_cgs, s1 + j1 * dl_cgs, s2, s3 + j3 * dl_cgs)
    r2_ = _couple_simple_c(*ss, j0, j1, j3, a_i, dl_cgs, thin)
    rot = _rotate_c(*ss, rho1, rho3, rho_p, rho_sq, dl_cgs)
    r3_ = (rot[0] + j0 * dl_cgs, rot[1] + j1 * dl_cgs,
           rot[2], rot[3] + j3 * dl_cgs)
    r4_ = _couple_absorption_c(*ss, j0, j1, j3, a1, a3, a_i, alpha_p,
                               alpha_sq, dl_cgs, thin)
    r5_ = _couple_matrix_c(*ss, j0, j1, j3, a1, a3, a_i, alpha_sq,
                           rho1, rho3, rho_sq, dl_cgs, thin)
    res = sel(a0_zero & rp_zero, r1_,
              sel(ap_zero & rp_zero, r2_,
                  sel(a0_zero, r3_, sel(rp_zero, r4_, r5_))))
    return admissibility_clamp_c(*res)


def couple_matter(ss_start, coeffs, dl_cgs, rotation_split: bool):
    """One matter-coupling step on tetrad-frame Stokes vectors.

    Args:
      ss_start: (..., 4) Stokes before coupling.
      coeffs: dict with j_i/j_q/j_v, alpha_i/alpha_q/alpha_v, rho_q/rho_v,
        each (...,).
      dl_cgs: (...,) CGS affine step.
      rotation_split: Strang-split rotation from absorption/emission
        (image_rotation_split).

    Returns (..., 4) Stokes after coupling and clamping.
    """
    j = jnp.stack([coeffs["j_i"], coeffs["j_q"],
                   jnp.zeros_like(coeffs["j_i"]), coeffs["j_v"]], axis=-1)
    a1 = coeffs["alpha_q"]
    a3 = coeffs["alpha_v"]
    a_i = coeffs["alpha_i"]
    rho1 = coeffs["rho_q"]
    rho3 = coeffs["rho_v"]
    alpha_sq = a1 * a1 + a3 * a3
    alpha_p = jnp.sqrt(alpha_sq)
    rho_sq = rho1 * rho1 + rho3 * rho3
    rho_p = jnp.sqrt(rho_sq)
    delta_tau = a_i * dl_cgs
    thin = delta_tau <= DELTA_TAU_MAX

    a0_zero = a_i == 0.0
    ap_zero = alpha_p == 0.0
    rp_zero = rho_p == 0.0

    if rotation_split:
        def half_couple(ss):
            r_free = ss + j * (dl_cgs / 2.0)[..., None]
            r_simple = _couple_simple(ss, j, a_i, dl_cgs / 2.0, thin)
            r_abs = _couple_absorption(ss, j, a1, a3, a_i, alpha_p, alpha_sq,
                                       dl_cgs / 2.0, thin)
            res = jnp.where(a0_zero[..., None], r_free,
                            jnp.where(ap_zero[..., None], r_simple, r_abs))
            return admissibility_clamp(res)

        ss = half_couple(ss_start)
        rotated = _rotate(ss, rho1, rho3, rho_p, rho_sq, dl_cgs)
        ss = jnp.where(rp_zero[..., None], ss, rotated)
        ss = admissibility_clamp(ss)
        ss = half_couple(ss)
        return admissibility_clamp(ss)

    # Unsplit ladder (polarized.cpp:571-779)
    r1 = ss_start + j * dl_cgs[..., None]
    r2 = _couple_simple(ss_start, j, a_i, dl_cgs, thin)
    r3 = _rotate(ss_start, rho1, rho3, rho_p, rho_sq, dl_cgs) \
        + j * dl_cgs[..., None]
    r4 = _couple_absorption(ss_start, j, a1, a3, a_i, alpha_p, alpha_sq,
                            dl_cgs, thin)
    r5 = _couple_matrix(ss_start, j, a1, a3, a_i, alpha_sq, rho1, rho3,
                        rho_sq, dl_cgs, thin)

    b1 = (a0_zero & rp_zero)[..., None]
    b2 = (ap_zero & rp_zero)[..., None]
    b3 = a0_zero[..., None]
    b4 = rp_zero[..., None]
    res = jnp.where(b1, r1, jnp.where(b2, r2, jnp.where(b3, r3,
                                                        jnp.where(b4, r4, r5))))
    return admissibility_clamp(res)
