"""Synchrotron emission/absorption/rotation coefficients from sampled GRMHD.

Batched re-derivation of the reference coefficient engine
(src/radiation_integrator/simulation_coefficients.cpp:51-722), following
2021 ApJ 921 17 (M). This module covers the thermal population (emissivity
M 28,30; Kirchhoff absorptivity M 31; Faraday rotativities M 33-37) plus
the power-law and kappa populations (further down in this same module),
which add into the same outputs.

Scalarized geometry throughout: the fluid 4-velocity/field construction uses
the sparse SKS metric (ops/sks.py) and the pitch angle falls out of
invariants - for null k in the fluid frame |k_tet|^2 = (k.u)^2 and
b_tet^2 = b.b, so cos(theta_B) = (k.b) / (|k.u| sqrt(b.b)) with no tetrad
construction at all (the full tetrad is only needed for polarized transport).

Float32 discipline: emissivities carry the unit factor e^2/(c nu0^2) in log
form (log_j_scale) so device values stay O(1); absorptivities are true CGS
invariants (alpha_nu * nu, O(1e-12..1) magnitudes).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax.numpy as jnp

from blacklight.constants import (
    HIGHEST, NUM_CELL_VALUES, CellValues, Math, Physics, PlasmaModel)
from blacklight.ops import geometry, sks

THETA_E_ZERO = 0.01  # reference radiation_integrator.hpp:190


@dataclasses.dataclass(frozen=True)
class PlasmaParams:
    """Plasma model parameters (reference input_reader.hpp:163-178)."""

    mu: float
    ne_ni: float
    model: PlasmaModel
    use_p: bool = True
    gamma: float = 5.0 / 3.0
    gamma_i: float = 5.0 / 3.0
    gamma_e: float = 4.0 / 3.0
    rat_low: float = 1.0
    rat_high: float = 1.0
    power_frac: float = 0.0
    power_p: float = 0.0
    gamma_min: float = 0.0
    gamma_max: float = 0.0
    kappa_frac: float = 0.0
    kappa: float = 0.0
    w: float = 0.0

    @property
    def thermal_frac(self):
        return 1.0 - (self.power_frac + self.kappa_frac)


@dataclasses.dataclass(frozen=True)
class CutParams:
    """Value cuts (negative = disabled; reference input_reader.hpp:181-194)."""

    rho_min: float = -1.0
    rho_max: float = -1.0
    n_e_min: float = -1.0
    n_e_max: float = -1.0
    p_gas_min: float = -1.0
    p_gas_max: float = -1.0
    theta_e_min: float = -1.0
    theta_e_max: float = -1.0
    b_min: float = -1.0
    b_max: float = -1.0
    sigma_min: float = -1.0
    sigma_max: float = -1.0
    beta_inverse_min: float = -1.0
    beta_inverse_max: float = -1.0


def fluid_state(pos, samples, spin, plasma: PlasmaParams, rho_unit: float,
                coords: str = "sks"):
    """Construct the CGS fluid state and CKS 4-vectors at sample points.

    Mirrors simulation_coefficients.cpp:287-358 (units, u^mu/b^mu in
    simulation coordinates, electron temperature) plus the Jacobian
    transform to CKS (:397-431). coords selects the simulation coordinate
    system: "sks" (scalarized sparse-metric path) or "cks" (AthenaK; the
    simulation metric IS the geodesic metric, radiation_geometry.cpp:
    425-458, and no Jacobian applies).

    Returns dict with n_e_cgs, bb_cgs, sigma, beta_inv, theta_e, kb_tt_e_cgs,
    rho_cgs, pgas_cgs, ucon (B,4) CKS, bcon (B,4) CKS, and b_sq.
    """
    x, y, z = pos[..., 1], pos[..., 2], pos[..., 3]
    rho = samples["rho"]
    pgas = samples["pgas"]
    uu1, uu2, uu3 = samples["uu1"], samples["uu2"], samples["uu3"]
    bb1, bb2, bb3 = samples["bb1"], samples["bb2"], samples["bb3"]

    d_unit = rho_unit
    e_unit = d_unit * Physics.c ** 2
    b_unit = math.sqrt(4.0 * Math.pi * e_unit)

    rho_cgs = rho * d_unit
    pgas_cgs = pgas * e_unit
    n_cgs = rho_cgs / (plasma.mu * Physics.m_p)
    n_e_cgs = n_cgs / (1.0 + 1.0 / plasma.ne_ni)

    if coords == "cks":
        # Normal-frame velocity + cell-frame B directly in CKS
        # (simulation_coefficients.cpp:296-328 with the CKS branch of the
        # simulation metric)
        g_cov, g_con = geometry.gcov_gcon(pos[..., 1:], spin)
        uu = jnp.stack([uu1, uu2, uu3], axis=-1)
        uu0 = jnp.sqrt(1.0 + jnp.einsum("...ij,...i,...j->...",
                                        g_cov[..., 1:, 1:], uu, uu,
                                        precision=HIGHEST))
        lapse = 1.0 / jnp.sqrt(-g_con[..., 0, 0])
        shift = -g_con[..., 0, 1:] / g_con[..., 0, 0:1]
        ut = uu0 / lapse
        u_sp = uu - shift * (uu0 / lapse)[..., None]
        ucon = jnp.concatenate([ut[..., None], u_sp], axis=-1)
        ucov = jnp.einsum("...ij,...j->...i", g_cov, ucon, precision=HIGHEST)
        bb = jnp.stack([bb1, bb2, bb3], axis=-1)
        bt = jnp.einsum("...i,...i->...", ucov[..., 1:], bb, precision=HIGHEST)
        b_sp = (bb + bt[..., None] * ucon[..., 1:]) / ut[..., None]
        bcon = jnp.concatenate([bt[..., None], b_sp], axis=-1)
        bcov = jnp.einsum("...ij,...j->...i", g_cov, bcon, precision=HIGHEST)
        b_sq = jnp.einsum("...i,...i->...", bcov, bcon, precision=HIGHEST)
    else:
        m = sks.sks_metric(x, y, z, spin)
        ut, ur, uth, uph = sks.normal_frame_velocity(m, uu1, uu2, uu3)
        ucov_t, ucov_r, ucov_th, ucov_ph = sks.lower_sks(m, ut, ur, uth, uph)

        # b^mu from cell-frame field (simulation_coefficients.cpp:315-328)
        bt = ucov_r * bb1 + ucov_th * bb2 + ucov_ph * bb3
        br = (bb1 + bt * ur) / ut
        bth = (bb2 + bt * uth) / ut
        bph = (bb3 + bt * uph) / ut
        bcov_t, bcov_r, bcov_th, bcov_ph = sks.lower_sks(m, bt, br, bth, bph)
        b_sq = bcov_t * bt + bcov_r * br + bcov_th * bth + bcov_ph * bph
    # sqrt'(0) = inf would NaN reverse-mode at zero-field cells even
    # though their emission is masked. float64 keeps the EXACT forward
    # values (bb = 0 at B = 0, so nu_c = 0 feeds the by-design 0 * inf
    # NaNs that poison those pixels like the reference) via a where,
    # whose transpose is a select that discards the inf cotangent;
    # float32 floors at 1e-30 code units ~ 3e-13 G instead (a where's
    # exact 0 would reintroduce 0-divisions downstream at f32 scales).
    f64 = b_sq.dtype == jnp.float64
    if f64:
        pos_b = b_sq > 0.0
        bb_cgs = jnp.where(pos_b, jnp.sqrt(jnp.where(pos_b, b_sq, 1.0)),
                           0.0) * b_unit
    else:
        bb_cgs = jnp.sqrt(jnp.maximum(b_sq, 1e-30)) * b_unit
    # Clamp divisors at point of use: rho/pgas may be an exact-zero user
    # fallback (legal input); a 0/0 NaN primal here would poison
    # reverse-mode through later products even when masked forward.
    # float32 floors sit at 1e-15, NOT epsilon: x/max(d, f)'s VJP carries
    # num * d^-2, and jax's maximum-VJP multiplies (not selects) the
    # cotangent by its 0/1 subgradient - an inf cotangent from f < ~1e-19
    # becomes 0 * inf = NaN at every degenerate cell. float64 keeps the
    # round-1 1e-30 floors (forward-inert for physical snapshots).
    dfloor = 1e-30 if f64 else 1e-15
    sigma = b_sq / jnp.maximum(rho, dfloor)
    beta_inv = b_sq / jnp.maximum(2.0 * pgas, dfloor)

    # Electron temperature (simulation_coefficients.cpp:330-358)
    if plasma.model == PlasmaModel.ti_te_beta:
        # Stable form of (rat_high + rat_low b^2)/(1 + b^2): beta_inv can
        # reach ~1e26 in float32 (pgas = 0 fallback cells), where b^2
        # overflows and inf/inf is a NaN primal; u = 1/(1+b^2) instead
        # passes through inf cleanly (1/inf = 0) in forward AND
        # reverse-mode.
        u_b = 1.0 / (1.0 + beta_inv ** 2)
        tti_tte = plasma.rat_high * u_b + plasma.rat_low * (1.0 - u_b)
        # pgas_cgs/rho_cgs = (pgas/rho) c^2, formed from the O(1) code-unit
        # ratio: dividing by rho_cgs (~1e-25 f32) is fine forward but its
        # VJP intermediate 1/rho_cgs^2 (~1e50) overflows float32 to inf,
        # poisoning d/d rho for every cell a ray touches.
        kb_tt_tot_cgs = (plasma.mu * Physics.m_p * Physics.c ** 2) \
            * (pgas / jnp.maximum(rho, dfloor))
        if plasma.use_p:
            kb_tt_e_cgs = (1.0 + plasma.ne_ni) / (tti_tte + plasma.ne_ni) \
                * kb_tt_tot_cgs
        else:
            kb_tt_e_cgs = (1.0 + plasma.ne_ni) * kb_tt_tot_cgs / (plasma.gamma - 1.0)
            kb_tt_e_cgs = kb_tt_e_cgs / (tti_tte / (plasma.gamma_i - 1.0)
                                         + plasma.ne_ni / (plasma.gamma_e - 1.0))
        theta_e = kb_tt_e_cgs / (Physics.m_e * Physics.c ** 2)
    else:  # code_kappa (E2 13)
        kappa = samples["kappa"]
        mu_e = plasma.mu * (1.0 + 1.0 / plasma.ne_ni)
        rho_e = rho * Physics.m_e / (mu_e * Physics.m_p)
        rho_kappa_e_cbrt = jnp.cbrt(rho_e * kappa)
        theta_e = 0.2 * (jnp.sqrt(1.0 + 25.0 * rho_kappa_e_cbrt ** 2) - 1.0)
        kb_tt_e_cgs = theta_e * Physics.m_e * Physics.c ** 2

    if coords != "cks":
        # Transform u, b to CKS (Jacobian, radiation_geometry.cpp:94-126)
        ux, uy, uz = sks.sks_to_cks_vector(ur, uth, uph, x, y, z, spin)
        bx, by, bz = sks.sks_to_cks_vector(br, bth, bph, x, y, z, spin)
        ucon = jnp.stack([ut, ux, uy, uz], axis=-1)
        bcon = jnp.stack([bt, bx, by, bz], axis=-1)

    return dict(rho_cgs=rho_cgs, pgas_cgs=pgas_cgs, n_e_cgs=n_e_cgs,
                bb_cgs=bb_cgs, sigma=sigma, beta_inv=beta_inv,
                theta_e=theta_e, kb_tt_e_cgs=kb_tt_e_cgs,
                ucon=ucon, bcon=bcon, b_sq=b_sq)


def value_cuts(state, cuts: CutParams):
    """Per-sample keep mask from cell-value cuts
    (simulation_coefficients.cpp:361-375)."""
    keep = jnp.ones_like(state["sigma"], dtype=bool)
    pairs = [
        ("rho_cgs", cuts.rho_min, cuts.rho_max),
        ("n_e_cgs", cuts.n_e_min, cuts.n_e_max),
        ("pgas_cgs", cuts.p_gas_min, cuts.p_gas_max),
        ("theta_e", cuts.theta_e_min, cuts.theta_e_max),
        ("bb_cgs", cuts.b_min, cuts.b_max),
        ("sigma", cuts.sigma_min, cuts.sigma_max),
        ("beta_inv", cuts.beta_inverse_min, cuts.beta_inverse_max),
    ]
    for name, lo, hi in pairs:
        if lo >= 0.0:
            keep &= ~(state[name] < lo)
        if hi >= 0.0:
            keep &= ~(state[name] > hi)
    return keep


def cell_values(state):
    """(B, NUM_CELL_VALUES) diagnostic values
    (simulation_coefficients.cpp:377-387)."""
    return jnp.stack([
        state["rho_cgs"], state["n_e_cgs"], state["pgas_cgs"],
        state["theta_e"], state["bb_cgs"], state["sigma"], state["beta_inv"],
    ], axis=-1)


def pitch_angle(pos, kcov, state, spin, flat=False):
    """Fluid-frame angle between wavevector and magnetic field via
    invariants (equivalent to the tetrad construction at
    simulation_coefficients.cpp:397-455 for null k):
      cos(theta_B) = (k.b) / (|k.u| sqrt(b.b)).

    Returns (sin_theta_b, cos_theta_b, sin2_theta_b, u_dot_k).
    """
    ucon, bcon = state["ucon"], state["bcon"]
    u_dot_k = jnp.einsum("...i,...i->...", ucon, kcov, precision=HIGHEST)
    b_dot_k = jnp.einsum("...i,...i->...", bcon, kcov, precision=HIGHEST)
    b_sq = state["b_sq"]
    # Dtype-aware floor: in float32, floors below ~1e-19 flush the VJP's
    # denom^-2 to inf (0/0 NaN primal at B = 0 cells) so weak-field
    # pitch angles clamp at 1e-16; float64 keeps 1e-300 - b_sq down to
    # ~1e-30 occurs in real snapshots outside the torus, and flooring it
    # would rotate those cells' pitch angles (golden-parity visible).
    floor = 1e-300 if b_sq.dtype == jnp.float64 else 1e-16
    denom = u_dot_k * u_dot_k * jnp.maximum(b_sq, floor)
    cos2 = jnp.minimum(b_dot_k * b_dot_k / denom, 1.0)
    sin2 = 1.0 - cos2
    # sqrt through a where, not a floor: sqrt'(0) = inf, and exact zeros
    # DO occur (B = 0 cells give cos2 = 0; field-aligned k gives
    # sin2 = 0). where's transpose is a select, so the inf cotangent is
    # discarded exactly; the cutoff (1e-24 f32 / 1e-300 f64) changes the
    # forward value by at most 1e-12 / not at all.
    cut = 1e-300 if b_sq.dtype == jnp.float64 else 1e-24

    def _safe_sqrt(z):
        return jnp.where(z > cut, jnp.sqrt(jnp.where(z > cut, z, 1.0)),
                         0.0)

    sin_theta_b = _safe_sqrt(sin2)
    cos_theta_b = _safe_sqrt(cos2) * jnp.where(b_dot_k >= 0.0, 1.0, -1.0)
    return sin_theta_b, cos_theta_b, sin2, u_dot_k


_EULER_GAMMA = 0.5772156649015328606

# Series length for the small-argument K0/K1 power series: t = x^2/4 <=
# 2.25 at the x = 3 switchover and term_k ~ t^k/(k!)^2, so 22 terms reach
# ~1e-31 - full float64 convergence.
_BESSEL_SERIES_TERMS = 22
# Steed/Temme CF2 iterations for x >= 2 (worst case is the x = 3
# switchover: 40 iterations reach 8e-14 relative; large x converges in
# far fewer).
_BESSEL_CF2_ITERS = 40


def _bessel_k01_small(x):
    """K0, K1 for x <= 2 by the exact ascending series (DLMF 10.31.2-3):
      K0 = -(ln(x/2)+gamma) I0 + sum_k t^k/(k!)^2 H_k
      K1 = 1/x + ln(x/2) I1 - (x/4) sum_k (H_k + H_{k+1} - 2 gamma)
                                             t^k/(k! (k+1)!)
    with t = x^2/4 and harmonic numbers H_k; float64-exact at 20 terms."""
    t = x * x / 4.0
    i0 = jnp.ones_like(x)
    k0_sum = jnp.zeros_like(x)
    i1_sum = jnp.ones_like(x)          # sum t^k / (k!(k+1)!), k=0 term = 1
    k1_sum = jnp.full_like(x, 1.0 - 2.0 * _EULER_GAMMA)  # k=0: H_0+H_1-2g
    tk = jnp.ones_like(x)
    fact = 1.0
    h = 0.0
    for k in range(1, _BESSEL_SERIES_TERMS + 1):
        fact *= k
        h += 1.0 / k
        tk = tk * t
        inv_sq = 1.0 / (fact * fact)
        i0 = i0 + tk * inv_sq
        k0_sum = k0_sum + tk * inv_sq * h
        inv_11 = 1.0 / (fact * fact * (k + 1.0))
        i1_sum = i1_sum + tk * inv_11
        k1_sum = k1_sum + tk * inv_11 * (2.0 * h + 1.0 / (k + 1.0)
                                         - 2.0 * _EULER_GAMMA)
    lnx2 = jnp.log(x / 2.0)
    i1 = 0.5 * x * i1_sum
    k0 = -(lnx2 + _EULER_GAMMA) * i0 + k0_sum
    k1 = 1.0 / x + lnx2 * i1 - 0.25 * x * k1_sum
    return k0, k1


def _bessel_k01_large(x, scaled=False):
    """K0, K1 for x >= 2 by the Steed continued fraction CF2 (Temme's
    method as in Thompson & Barnett 1987; the mu = 0 case): evaluates
    K0 = sqrt(pi/2x) e^{-x}/S and the K1 ladder without tabulated
    coefficients, to full double precision in ~25 iterations. scaled
    drops the e^{-x} factor (returns e^x K), which cannot underflow."""
    a1 = 0.25
    b = 2.0 * (1.0 + x)
    d = 1.0 / b
    h = d
    delh = d
    q1 = jnp.zeros_like(x)
    q2 = jnp.ones_like(x)
    q = jnp.full_like(x, a1)
    c = jnp.full_like(x, a1)
    a = -a1
    s = 1.0 + q * delh
    for i in range(2, _BESSEL_CF2_ITERS + 2):
        a = a - 2.0 * (i - 1)
        c = -a * c / i
        qnew = (q1 - b * q2) / a
        q1, q2 = q2, qnew
        q = q + c * qnew
        b = b + 2.0
        d = 1.0 / (b + a * d)
        delh = (b * d - 1.0) * delh
        h = h + delh
        s = s + q * delh
    h = a1 * h
    pref = jnp.sqrt(jnp.pi / (2.0 * x))
    if not scaled:
        pref = pref * jnp.exp(-x)
    k0 = pref / s
    k1 = k0 * (x + 0.5 - h) / x
    return k0, k1


def _bessel_k01_asymptotic(x, terms: int = 8):
    """e^x K0, e^x K1 from the large-x asymptotic series
    e^x K_nu = sqrt(pi/2x) sum_k a_k(nu) x^-k,
    a_k(nu) = a_{k-1} (4 nu^2 - (2k-1)^2)/(8k). Optimal-truncation error
    at the x = 3 switchover is ~1e-3 relative, decaying like e^{-2x}
    (5e-5 at x = 5, 2e-9 at x = 10) - used only for the float32 path,
    whose CF2 intermediates overflow single precision."""
    inv = 1.0 / x
    p0 = jnp.ones_like(x)
    p1 = jnp.ones_like(x)
    a0 = 1.0
    a1 = 1.0
    xk = inv
    for k in range(1, terms + 1):
        m = (2.0 * k - 1.0) ** 2
        a0 *= (0.0 - m) / (8.0 * k)
        a1 *= (4.0 - m) / (8.0 * k)
        p0 = p0 + a0 * xk
        p1 = p1 + a1 * xk
        xk = xk * inv
    pref = jnp.sqrt(jnp.pi / (2.0 * x))
    return pref * p0, pref * p1


def _bessel_k012_scaled(x):
    """(e^x K0, e^x K1, e^x K2): underflow-free Bessel K for ratio work.

    K(x) underflows float32 near x ~ 80 (0/0 NaN in K ratios) while the
    scaled values stay O(sqrt(pi/2x)); the thermal rotativities' Bessel
    ratios use these so cold cells (theta_e -> THETA_E_ZERO, x -> 100)
    stay finite in float32 forward AND reverse. The large branch is the
    exact CF2 in float64 and the asymptotic series in float32 (the CF2's
    internal recurrences overflow single precision)."""
    small = x <= 3.0
    xs = jnp.where(small, jnp.maximum(x, 1e-30), 3.0)
    xl = jnp.where(small, 3.0, x)
    k0_s, k1_s = _bessel_k01_small(xs)
    e = jnp.exp(xs)
    if x.dtype == jnp.float64:
        k0_l, k1_l = _bessel_k01_large(xl, scaled=True)
    else:
        k0_l, k1_l = _bessel_k01_asymptotic(xl)
    k0 = jnp.where(small, k0_s * e, k0_l)
    k1 = jnp.where(small, k1_s * e, k1_l)
    return k0, k1, k0 + 2.0 * k1 / x


def _bessel_k(order: int, x):
    """Modified Bessel K_0/K_1/K_2 to float64 accuracy (rel err < 1e-13
    over x in [1e-6, 700]; tests/test_special_functions.py vs scipy).

    The reference leans on std::cyl_bessel_k (double,
    simulation_coefficients.cpp:526-556); jax has no cyl_bessel_k, so
    K0/K1 come from the exact ascending series (x <= 3) and the Steed
    CF2 continued fraction (x > 3), with K2 = K0 + 2 K1/x."""
    small = x <= 3.0
    xs = jnp.where(small, jnp.maximum(x, 1e-300), 3.0)
    xl = jnp.where(small, 3.0, x)
    k0_s, k1_s = _bessel_k01_small(xs)
    k0_l, k1_l = _bessel_k01_large(xl)
    k0 = jnp.where(small, k0_s, k0_l)
    k1 = jnp.where(small, k1_s, k1_l)
    if order == 0:
        return k0
    if order == 1:
        return k1
    return k0 + 2.0 * k1 / x


def log_j_scale(nu0: float):
    """log of the emissivity unit factor e^2/(c nu0^2) pulled out of j."""
    return 2.0 * math.log(Physics.e) - math.log(Physics.c) - 2.0 * math.log(nu0)


def hypergeometric(alpha: float, beta: float, gamma: float, z: float) -> float:
    """2F1 via Pfaff transformation + 10-term series
    (reference simulation_coefficients.cpp:740-773). Host-side scalar."""
    a, bb, c = alpha, gamma - beta, gamma
    x = z / (z - 1.0)
    result = 1.0
    a_k = b_k = c_k = xk = k_fact = 1.0
    for k in range(1, 11):
        a_k *= a + k - 1.0
        b_k *= bb + k - 1.0
        c_k *= c + k - 1.0
        xk *= x
        k_fact *= k
        result += a_k * b_k * xk / (c_k * k_fact)
    return result * (1.0 - z) ** (-alpha)


def powerlaw_constants(p: PlasmaParams) -> dict:
    """Precomputed power-law population constants (M 38-42;
    simulation_coefficients.cpp:54-80)."""
    pp = p.power_p
    var_c = p.gamma_min ** (1.0 - pp) - p.gamma_max ** (1.0 - pp)
    out = {
        "jj": (3.0 ** (pp / 2.0) * (pp - 1.0)) / (2.0 * (pp + 1.0)) / var_c
              * math.gamma((3.0 * pp - 1.0) / 12.0)
              * math.gamma((3.0 * pp + 19.0) / 12.0),
        "aa": (3.0 ** ((pp + 1.0) / 2.0) * (pp - 1.0) / 4.0) / var_c
              * math.gamma((3.0 * pp + 2.0) / 12.0)
              * math.gamma((3.0 * pp + 22.0) / 12.0),
        "jj_q": -(pp + 1.0) / (pp + 7.0 / 3.0),
        "jj_v": 0.684 * pp ** 0.49,
        "aa_q": -((0.034 * pp - 0.0344) ** 0.086),
        "aa_v": (0.71 * pp + 0.0352) ** 0.394,
        "rho": (pp - 1.0) / var_c,
        "rho_q": -(p.gamma_min ** (2.0 - pp)) / (pp / 2.0 - 1.0),
        "rho_v": (2.0 * (pp + 2.0) / (pp + 1.0)) * p.gamma_min ** (-(pp + 1.0))
                 * math.log(p.gamma_min),
    }
    return out


def kappa_constants(p: PlasmaParams, polarized: bool = False) -> dict:
    """Precomputed kappa-distribution constants (M 43-54;
    simulation_coefficients.cpp:82-193), including the Bessel-K ratio and
    the kappa-bracket interpolation coefficients.

    Reference quirk reproduced deliberately: kappa_aa_high_i is only
    initialized when image_light and image_polarization
    (simulation_coefficients.cpp:120), yet the unpolarized alpha_i bridge
    uses it (:661) - so unpolarized runs get ZERO kappa absorption (the
    bridge sees pow(0, -x) = inf). Pass polarized accordingly."""
    kap, w = p.kappa, p.w
    var_h = w * kap
    out = {
        "jj_low": (4.0 * Math.pi * math.gamma(kap - 4.0 / 3.0))
                  / (3.0 ** (7.0 / 3.0) * math.gamma(kap - 2.0)),
        "jj_high": (3.0 ** ((kap - 1.0) / 2.0) * (kap - 2.0) * (kap - 1.0) / 4.0
                    * math.gamma(kap / 4.0 - 1.0 / 3.0)
                    * math.gamma(kap / 4.0 + 4.0 / 3.0)),
        "jj_x_i": 3.0 * kap ** (-1.5),
        "aa_low": (3.0 ** (1.0 / 6.0) * 10.0 / 41.0
                   * 2.0 * Math.pi * var_h ** (kap - 10.0 / 3.0)
                   * ((kap - 2.0) * (kap - 1.0) * kap) / (3.0 * kap - 1.0)
                   * math.gamma(5.0 / 3.0)
                   * hypergeometric(kap - 1.0 / 3.0, kap + 1.0, kap + 2.0 / 3.0,
                                    -var_h)),
        "aa_high": (Math.pi ** 1.5 / 3.0
                    * ((kap - 2.0) * (kap - 1.0) * kap / var_h ** 3)
                    * (2.0 * math.gamma(2.0 + kap / 2.0) / (2.0 + kap) - 1.0)),
        "aa_x_i": (-1.75 + 1.6 * kap) ** (-0.86),
        "jj_low_q": 0.5,
        "jj_low_v": 0.5625 * kap ** (-0.528) / w,
        "jj_high_q": 0.64 + 0.02 * kap,
        "jj_high_v": 0.765625 * kap ** (-0.44) / w,
        "jj_x_q": 3.7 * kap ** (-1.6),
        "jj_x_v": 3.0 * kap ** (-1.5),
        "aa_low_q": 25.0 / 48.0,
        "aa_low_v": 77.0 / (100.0 * w) * kap ** (-0.7),
        "aa_high_i": ((3.0 / kap) ** 4.75 + 0.6) if polarized else 0.0,
        "aa_high_q": 441.0 * kap ** (-5.76) + 0.55,
        "aa_high_v": (14.3 * w ** (-0.928))
                     * (169.0 * kap ** (-8.0) + 0.0052 * kap - 0.0526
                        + 47.0 / (200.0 * kap)),
        "aa_x_q": 1.4 * kap ** (-1.15),
        "aa_x_v": 1.22 * kap ** (-1.136) + 0.007,
        "rho_v": float(_bessel_k(0, jnp.asarray(1.0 / w))
                       / _bessel_k(2, jnp.asarray(1.0 / w))),
    }

    def q_set(a, bb, c, d, e):
        return dict(a=a, b=bb, c=c, d=d, e=e)

    q35 = q_set(17.0 * w + math.sqrt(w) * (-3.0 + 7.0 * math.exp(-5.0 * w)),
                -1.0 / 30.0, 0.1, -1.5, 0.471)
    q40 = q_set(46.0 / 3.0 * w + math.sqrt(w) * (-5.0 / 3.0
                                                 + 17.0 / 3.0 * math.exp(-5.0 * w)),
                -1.0 / 18.0, 1.0 / 6.0, -1.75, 0.5)
    q45 = q_set(14.0 * w + math.sqrt(w) * (-1.625 + 4.5 * math.exp(-5.0 * w)),
                -1.0 / 12.0, 0.25, -2.0, 0.525)
    q50 = q_set(12.5 * w + math.sqrt(w) * (-1.0 + 5.0 * math.exp(-5.0 * w)),
                -0.125, 0.375, -2.25, 0.541)
    v35 = ((w * w + 2.0 * w + 1.0) / (3.125 * w * w + 4.0 * w + 1.0), 0.447)
    v40 = ((w * w + 54.0 * w + 50.0) / (30.0 / 11.0 * w * w + 134.0 * w + 50.0),
           0.391)
    v45 = ((w * w + 43.0 * w + 38.0) / (7.0 / 3.0 * w * w + 92.5 * w + 38.0),
           0.348)
    v50 = ((w + 13.0 / 14.0) / (2.0 * w + 13.0 / 14.0), 0.313)
    if kap < 4.0:
        out["rho_frac"] = (kap - 3.5) / 0.5
        out["rho_q_low"], out["rho_q_high"] = q35, q40
        out["rho_v_low"], out["rho_v_high"] = v35, v40
    elif kap < 4.5:
        out["rho_frac"] = (kap - 4.0) / 0.5
        out["rho_q_low"], out["rho_q_high"] = q40, q45
        out["rho_v_low"], out["rho_v_high"] = v40, v45
    else:
        out["rho_frac"] = (kap - 4.5) / 0.5
        out["rho_q_low"], out["rho_q_high"] = q45, q50
        out["rho_v_low"], out["rho_v_high"] = v45, v50
    return out


def powerlaw_coefficients(nu_cgs, nu0: float, state, sin_theta_b, cos_theta_b,
                          sin2_theta_b, plasma: PlasmaParams, consts: dict,
                          polarized: bool):
    """Power-law population coefficients (M 28-29, 38-42;
    simulation_coefficients.cpp:558-605), same scaling as thermal."""
    out = {}
    n_e = state["n_e_cgs"][..., None]
    sin_b = sin_theta_b[..., None]
    cos_b = cos_theta_b[..., None]
    frac = plasma.power_frac
    pp = plasma.power_p
    nu_c = Physics.e * state["bb_cgs"][..., None] \
        / (2.0 * Math.pi * Physics.m_e * Physics.c)
    # float64 keeps the LITERAL reference expressions - including their
    # by-design non-finite values at exactly-degenerate cells (sin = 0 /
    # B = 0 give inf/NaN that flag coeff_bad and poison the pixel just as
    # the C++ NaNs do; golden-parity visible). float32 (the gradient/fast
    # path) hardens them: a 1e-12 floor on nu_c sin (f32-representable,
    # VJP-finite), sin clamped away from {0, 1} for the fractional sin
    # powers whose VJPs blow up at the endpoints, and the 0 * inf
    # products cancelled algebraically. The f32 clamps only move
    # exactly-degenerate cells, whose coefficients vanish.
    f64 = nu_cgs.dtype == jnp.float64
    ncs = jnp.maximum(nu_c * sin_b, 1e-300 if f64 else 1e-12)
    sin_c = sin_b if f64 else jnp.clip(sin_b, 1e-6, 1.0 - 1e-7)
    ratio = nu_cgs / ncs

    # Emissivity in units of e^2 nu0^2 / c (matching log_j_scale)
    var_a = jnp.power(ratio, -(pp - 1.0) / 2.0)
    coeff_j = frac * n_e * nu_c * (nu0 / nu_cgs) ** 2 * consts["jj"] * sin_b * var_a
    out["j_i"] = coeff_j
    if polarized:
        out["j_q"] = coeff_j * consts["jj_q"]
        if f64:
            var_b = cos_b / sin_b
            var_c = 1.0 / jnp.sqrt(nu_cgs / (3.0 * nu_c * sin_b))
            out["j_v"] = coeff_j * consts["jj_v"] * var_b * var_c
        else:
            # (cos/sin) * sqrt(3 nu_c sin / nu) with the sin cancelled
            # algebraically: the literal product is 0 * inf at sin = 0.
            arg = 3.0 * ncs / nu_cgs
            root = jnp.where(arg > 1e-30,
                             jnp.sqrt(jnp.where(arg > 1e-30, arg, 1.0)), 0.0)
            coeff_j_nosin = frac * n_e * nu_c * (nu0 / nu_cgs) ** 2 \
                * consts["jj"] * var_a
            out["j_v"] = coeff_j_nosin * consts["jj_v"] * cos_b * root

    # Absorptivity (true invariant CGS): base has units e^2/(m_e c);
    # invariant alpha * nu handled by the nu-free form as in thermal.
    ka = Physics.e * Physics.e / (Physics.m_e * Physics.c)
    var_a2 = jnp.power(ratio, -(pp + 2.0) / 2.0)
    coeff_a = frac * n_e * ka * consts["aa"] * var_a2
    out["alpha_i"] = coeff_a
    if polarized:
        var_b2 = jnp.power(jnp.power(sin_c, -1.92) * 3.1 - 3.1, 0.512)
        var_c2 = 1.0 / jnp.sqrt(ratio)
        var_d2 = jnp.where(cos_b >= 0.0, 1.0, -1.0)
        out["alpha_q"] = coeff_a * consts["aa_q"]
        out["alpha_v"] = coeff_a * consts["aa_v"] * var_b2 * var_c2 * var_d2

        if f64:
            # Rotativities (M 40-42), literal forms
            var_a3 = n_e * ka * nu_cgs / (nu_c * sin_b)
            var_b3 = nu_c * sin_b / nu_cgs
            var_c3 = var_b3 * var_b3
            var_d3 = var_c3 * var_b3
            var_e3 = 1.0 - jnp.power(
                2.0 * nu_c * plasma.gamma_min ** 2 * sin_b / (3.0 * nu_cgs),
                pp / 2.0 - 1.0)
            var_f3 = cos_b / sin_b
            coeff_r = frac * consts["rho"] * var_a3
            out["rho_q"] = coeff_r * consts["rho_q"] * var_d3 * var_e3
            out["rho_v"] = coeff_r * consts["rho_v"] * var_c3 * var_f3
        else:
            # Rotativities (M 40-42), with the 1/(nu_c sin) of var_a3
            # cancelled into var_d3/var_c3 (the literal products are
            # inf * 0 at B = 0): a3 d3 = n_e ka (nu_c sin)^2 / nu^2 and
            # a3 c3 f3 = n_e ka nu_c cos / nu.
            var_e3 = 1.0 - jnp.power(jnp.maximum(
                2.0 * nu_c * plasma.gamma_min ** 2 * sin_b / (3.0 * nu_cgs),
                1e-20), pp / 2.0 - 1.0)
            coeff_r = frac * consts["rho"] * n_e * ka
            out["rho_q"] = coeff_r * consts["rho_q"] \
                * (ncs / nu_cgs) ** 2 * var_e3
            out["rho_v"] = coeff_r * consts["rho_v"] * nu_c * cos_b / nu_cgs
    return out


def _bridge(low, high, x):
    """Low/high-frequency bridging (low^-x + high^-x)^(-1/x), homogeneous of
    degree 1 so the j unit scale factors through.

    Evaluated as m (1 + (m/M)^x)^(-1/x) with m/M = min/max (exact
    algebra): the literal form's low^-x is inf at low = 0 (degenerate
    cells) and its VJP NaNs even under a zero cotangent; the ratio form
    keeps every intermediate in [0, 2]."""
    m = jnp.minimum(low, high)
    mm = jnp.maximum(low, high)
    # Denominator floor is dtype-aware: the division VJP forms mm^-2,
    # which overflows float32 below ~5e-20. Pairs that small bridge to a
    # physically-zero coefficient either way (tau contribution < 1e-6).
    tiny = 1e-150 if jnp.asarray(m).dtype == jnp.float64 else 1e-18
    ok = mm > tiny
    r = jnp.where(ok, m, 0.0) / jnp.where(ok, mm, 1.0)
    pos = r > 1e-30
    rx = jnp.where(pos, jnp.power(jnp.where(pos, r, 1.0), x), 0.0)
    return m * jnp.power(1.0 + rx, -1.0 / x)


def kappa_coefficients(nu_cgs, nu0: float, state, sin_theta_b, cos_theta_b,
                       sin2_theta_b, plasma: PlasmaParams, consts: dict,
                       polarized: bool):
    """Kappa-distribution coefficients (M 28-29, 43-54;
    simulation_coefficients.cpp:607-698)."""
    out = {}
    n_e = state["n_e_cgs"][..., None]
    sin_b = sin_theta_b[..., None]
    cos_b = cos_theta_b[..., None]
    sin2_b = sin2_theta_b[..., None]
    frac = plasma.kappa_frac
    kap, w = plasma.kappa, plasma.w
    nu_c = Physics.e * state["bb_cgs"][..., None] \
        / (2.0 * Math.pi * Physics.m_e * Physics.c)
    nu_kappa = nu_c * w * w * kap * kap * sin_b
    # float64 keeps the literal reference expressions (by-design inf/NaN
    # at degenerate cells -> coeff_bad pixel poisoning, golden-parity
    # visible). float32 hardens: a 1e-12 floor (f32-representable with
    # finite VJP) and sin clamped away from {0, 1} for the fractional
    # sin powers (endpoint VJPs are inf); only exactly-degenerate cells
    # move, and their emissivities vanish through sin_b / xx powers.
    f64 = nu_cgs.dtype == jnp.float64
    xx = nu_cgs / jnp.maximum(nu_kappa, 1e-300 if f64 else 1e-12)
    sin_cl = sin_b if f64 else jnp.clip(sin_b, 1e-6, 1.0 - 1e-7)

    # Emissivities, scaled by e^2 nu0^2 / c
    var_a = frac * n_e * nu_c * (nu0 / nu_cgs) ** 2
    var_b = jnp.cbrt(xx) * sin_b
    var_c = jnp.power(xx, -(kap - 2.0) / 2.0) * sin_b
    c_low = consts["jj_low"] * var_a * var_b
    c_high = consts["jj_high"] * var_a * var_c
    out["j_i"] = _bridge(c_low, c_high, consts["jj_x_i"])
    if polarized:
        var_d = jnp.power(jnp.power(sin_cl, -2.4) - 1.0, 0.48)
        var_e = jnp.power(xx, -0.35)
        var_f = jnp.power(jnp.power(sin_cl, -2.5) - 1.0, 0.44)
        var_g = 1.0 / jnp.sqrt(xx)
        var_h = jnp.where(cos_b >= 0.0, 1.0, -1.0)
        out["j_q"] = -_bridge(c_low * consts["jj_low_q"],
                              c_high * consts["jj_high_q"], consts["jj_x_q"])
        out["j_v"] = _bridge(c_low * consts["jj_low_v"] * var_d * var_e,
                             c_high * consts["jj_high_v"] * var_f * var_g,
                             consts["jj_x_v"]) * var_h

    # Absorptivities (true CGS)
    ka = Physics.e * Physics.e / (Physics.m_e * Physics.c)
    var_a2 = frac * n_e * ka
    a_low = consts["aa_low"] * var_a2 * jnp.power(xx, -2.0 / 3.0)
    a_high = consts["aa_high"] * var_a2 * jnp.power(xx, -(1.0 + kap) / 2.0)
    out["alpha_i"] = _bridge(a_low, a_high * consts["aa_high_i"],
                             consts["aa_x_i"])
    if polarized:
        var_d2 = jnp.power(jnp.power(sin_cl, -2.28) - 1.0, 0.446)
        var_e2 = jnp.power(xx, -0.35)
        var_f2 = jnp.sqrt(jnp.power(sin_cl, -2.05) - 1.0)
        var_g2 = 1.0 / jnp.sqrt(xx)
        var_h2 = jnp.where(cos_b >= 0.0, 1.0, -1.0)
        out["alpha_q"] = -_bridge(a_low * consts["aa_low_q"],
                                  a_high * consts["aa_high_q"], consts["aa_x_q"])
        out["alpha_v"] = _bridge(a_low * consts["aa_low_v"] * var_d2 * var_e2,
                                 a_high * consts["aa_high_v"] * var_f2 * var_g2,
                                 consts["aa_x_v"]) * var_h2

        # Rotativities (M 51-54)
        var_a3 = -frac * n_e * ka * nu_c ** 2 * sin2_b / (nu_cgs * nu_cgs)
        var_b3 = frac * 2.0 * n_e * ka * nu_c * cos_b / nu_cgs
        var_c3 = 1.0 / jnp.sqrt(xx)

        def rho_q_term(q):
            return var_a3 * q["a"] * (
                1.0 - jnp.exp(q["b"] * jnp.power(xx, 0.84))
                - jnp.sin(q["c"] * xx) * jnp.exp(q["d"] * jnp.power(xx, q["e"])))

        def rho_v_term(v):
            a, bb = v
            return consts["rho_v"] * var_b3 * a \
                * (1.0 - 0.17 * jnp.log1p(bb * var_c3))

        fr = consts["rho_frac"]
        out["rho_q"] = (1.0 - fr) * rho_q_term(consts["rho_q_low"]) \
            + fr * rho_q_term(consts["rho_q_high"])
        out["rho_v"] = (1.0 - fr) * rho_v_term(consts["rho_v_low"]) \
            + fr * rho_v_term(consts["rho_v_high"])
    return out


def all_coefficients(nu_cgs, nu0: float, state, sin_theta_b, cos_theta_b,
                     sin2_theta_b, plasma: PlasmaParams, polarized: bool,
                     pl_consts: Optional[dict] = None,
                     kp_consts: Optional[dict] = None):
    """Sum of thermal + power-law + kappa populations
    (reference accumulates += into shared arrays)."""
    keys = ["j_i", "alpha_i"]
    if polarized:
        keys += ["j_q", "j_v", "alpha_q", "alpha_v", "rho_q", "rho_v"]
    total = None
    if plasma.thermal_frac != 0.0:
        total = thermal_coefficients(nu_cgs, nu0, state, sin_theta_b,
                                     cos_theta_b, sin2_theta_b, plasma,
                                     polarized)
    if plasma.power_frac != 0.0:
        part = powerlaw_coefficients(nu_cgs, nu0, state, sin_theta_b,
                                     cos_theta_b, sin2_theta_b, plasma,
                                     pl_consts, polarized)
        total = part if total is None else {
            k: total.get(k, 0.0) + part.get(k, 0.0) for k in keys}
    if plasma.kappa_frac != 0.0:
        part = kappa_coefficients(nu_cgs, nu0, state, sin_theta_b,
                                  cos_theta_b, sin2_theta_b, plasma,
                                  kp_consts, polarized)
        total = part if total is None else {
            k: total.get(k, 0.0) + part.get(k, 0.0) for k in keys}
    if total is None:
        z = jnp.zeros_like(nu_cgs)
        total = {k: z for k in keys}
    for k in keys:
        total.setdefault(k, jnp.zeros_like(nu_cgs))
    return total


def thermal_coefficients(nu_cgs, nu0: float, state, sin_theta_b, cos_theta_b,
                         sin2_theta_b, plasma: PlasmaParams, polarized: bool):
    """Thermal synchrotron coefficients at fluid-frame frequencies nu_cgs (B,F).

    Returns dict with scaled invariant emissivities j_i[, j_q, j_v] (divide by
    exp(log_j_scale(nu0)) for CGS) and true invariant absorptivities
    alpha_i[, alpha_q, alpha_v] and rotativities rho_q, rho_v.

    Emissivity: M 28,30 (simulation_coefficients.cpp:469-496); absorptivity
    via Kirchhoff (M 31, :498-524 with the 1/alpha^2 overflow trap);
    rotativities M 33-37 (:526-556 with the theta_e -> 0 trap).
    """
    out = {}
    theta_e = state["theta_e"][..., None]
    kb_tt_e = state["kb_tt_e_cgs"][..., None]
    n_e = state["n_e_cgs"][..., None]
    sin_b = sin_theta_b[..., None]
    cos_b = cos_theta_b[..., None]
    sin2_b = sin2_theta_b[..., None]
    frac = plasma.thermal_frac

    nu_2 = nu_cgs * nu_cgs
    nu_c = Physics.e * state["bb_cgs"][..., None] \
        / (2.0 * Math.pi * Physics.m_e * Physics.c)
    # float32 ONLY: floor nu_s at 1e-12 Hz (not epsilon) so xx**(4/3)
    # (rho_q's var_d2) stays inside float32 range AND the division VJP's
    # nu * nu_s^-2 stays finite, and cap xx at 1e20 for the same reason;
    # degenerate cells (B = 0, theta_e = 0, field-aligned k) have
    # exp(-xx^(1/3)) = 0 either way. float64 keeps the literal reference
    # values: the cap is NOT harmless there - delta_jj_5(1e20) ~ 6e-16
    # can exceed K0(1/theta_e) at cold cells where the uncapped
    # delta_jj_5(1e30) ~ 1e-22 does not, flipping rho_v's trap branch
    # (simulation_coefficients.cpp:546-556) and moving V_nu at the 1e-3
    # level.
    f64 = nu_cgs.dtype == jnp.float64
    nu_s = 2.0 / 9.0 * nu_c * theta_e ** 2 * sin_b
    nu_s = jnp.maximum(nu_s, 1e-300 if f64 else 1e-12)
    xx = nu_cgs / nu_s
    if not f64:
        xx = jnp.minimum(xx, 1e20)
    xx_1_3 = jnp.cbrt(xx)
    xx_1_2 = jnp.sqrt(xx)
    xx_1_6 = jnp.sqrt(xx_1_3)
    # coefficient in units of e^2 nu0^2 / c: frac * n_e * nu_c * (nu0/nu)^2 * exp
    coefficient = frac * n_e * nu_c * (nu0 / nu_cgs) ** 2 * jnp.exp(-xx_1_3)
    var_a = Math.sqrt2 * Math.pi / 27.0 * sin_b
    var_b = 2.0 ** (11.0 / 12.0)
    var_c = xx_1_2 + var_b * xx_1_6
    j_i = coefficient * var_a * var_c * var_c
    out["j_i"] = j_i
    if polarized:
        # float32: theta_e floored at 1e-15 inside pow/divide: x**0.96's
        # VJP carries x**(-0.04) (inf at 0) and cos_b/theta_e is a
        # 0-division at cold cells; both make NaN reverse-mode
        # primal-products even though j_q/j_v vanish there through
        # `coefficient`. float64 keeps the literal division (by-design
        # inf at theta_e = 0, reference parity).
        theta_f = theta_e if f64 else jnp.maximum(theta_e, 1e-15)
        var_d = (7.0 * theta_f ** 0.96 + 35.0) \
            / (10.0 * theta_f ** 0.96 + 75.0) * var_b
        var_e = xx_1_2 + var_d * xx_1_6
        var_f = cos_b / theta_f
        var_g = (Math.pi / 3.0 + Math.pi / 3.0 * xx_1_3 + 2.0 / 300.0 * xx_1_2
                 + 2.0 / 19.0 * Math.pi * xx_1_3 ** 2)
        out["j_q"] = -coefficient * var_a * var_e * var_e
        out["j_v"] = coefficient * var_f * var_g

    # Kirchhoff absorption: alpha_inv = j_cgs/B_nu * nu. With j carrying the
    # e^2/(c nu0^2) scale, alpha_inv = j_scaled * expm1(h nu/kT) * K where
    # K = e^2 c nu / (2 h nu0^2) - computed in log space for float32.
    # float32 ONLY: kb floor keeps the division's VJP (hnu/kb^2) inside
    # float32, and the 87 cap keeps expm1 finite (e^88 overflows f32);
    # beyond hnu/kT = 87 the step is totally opaque either way (delta_tau
    # saturates DELTA_TAU_MAX). float64 keeps the UNCAPPED reference
    # semantics (simulation_coefficients.cpp:508-510): at ultra-cold
    # cells expm1 genuinely overflows/saturates exactly as the C++ does,
    # which the golden-parity suite pins at 1e-3 - a cap there changes
    # marginal cells' optical depth by factors up to e^600.
    if nu_cgs.dtype == jnp.float64:
        hnu_kt = Physics.h * nu_cgs / kb_tt_e
    else:
        hnu_kt = jnp.minimum(Physics.h * nu_cgs
                             / jnp.maximum(kb_tt_e, 1e-18), 87.0)
    log_k = (2.0 * math.log(Physics.e) + math.log(Physics.c)
             - math.log(2.0 * Physics.h) - 2.0 * math.log(nu0))
    kirchhoff = jnp.expm1(hnu_kt) * math.exp(log_k)
    alpha_i = j_i * kirchhoff
    # Overflow trap (simulation_coefficients.cpp:512-523)
    bad = jnp.isinf(1.0 / (alpha_i * alpha_i))
    out["alpha_i"] = jnp.where(bad, 0.0, alpha_i)
    if polarized:
        out["alpha_q"] = jnp.where(bad, 0.0, out["j_q"] * kirchhoff)
        out["alpha_v"] = jnp.where(bad, 0.0, out["j_v"] * kirchhoff)

        # Faraday rotativities (M 33-37)
        coefficient_q = -frac * n_e * Physics.e ** 2 * nu_c ** 2 * sin2_b \
            / (Physics.m_e * Physics.c * nu_2)
        coefficient_v = frac * 2.0 * n_e * Physics.e ** 2 * nu_c * cos_b \
            / (Physics.m_e * Physics.c * nu_cgs)
        xx_neg_1_2 = 1.0 / jnp.sqrt(xx)
        var_a2 = 2.011 * jnp.exp(-19.78 * xx ** (-0.5175))
        var_b2 = jnp.cos(39.89 * xx_neg_1_2) * jnp.exp(-70.16 * xx ** (-0.6))
        var_c2 = 0.011 * jnp.exp(-1.69 * xx_neg_1_2)
        var_d2 = 0.003135 * xx ** (4.0 / 3.0)
        var_e2 = 0.5 * (1.0 + jnp.tanh(10.0 * jnp.log(0.6648 * xx_neg_1_2)))
        f_0 = var_a2 - var_b2 - var_c2
        f_m = f_0 + (var_c2 - var_d2) * var_e2
        if f64:
            # Literal reference forms (simulation_coefficients.cpp:
            # 526-556): inv_theta <= 1/THETA_E_ZERO = 100 so the unscaled
            # K's never underflow double precision, and the direct
            # (K0 - delta)/K2 with the <0 / >1 trap is exactly the C++
            # trap; cancellation near delta ~ K0 resolves at full
            # precision with no log-space roundtrip.
            inv_theta = 1.0 / jnp.maximum(theta_e, THETA_E_ZERO)
            kk_0 = _bessel_k(0, inv_theta)
            kk_1 = _bessel_k(1, inv_theta)
            kk_2 = _bessel_k(2, inv_theta)
            delta_jj_5 = 0.4379 * jnp.log(1.0 + 1.3414 * xx ** (-0.7515))
            factor_q = f_m * (kk_1 / kk_2 + 6.0 * theta_e)
            factor_v = (kk_0 - delta_jj_5) / kk_2
            factor_v = jnp.where((factor_v < 0.0) | (factor_v > 1.0), 1.0,
                                 factor_v)
        else:
            inv_theta = jnp.maximum(1.0 / jnp.maximum(theta_e, THETA_E_ZERO),
                                    1e-15)
            # e^x-scaled K's: the unscaled values underflow float32 near
            # x ~ 80 (reachable: theta_e -> THETA_E_ZERO gives x = 100)
            # and their ratios become 0/0 NaN primals. All uses below are
            # ratios, where the e^x factor cancels exactly.
            kk_0s, kk_1s, kk_2s = _bessel_k012_scaled(inv_theta)
            # log1p, not log(1 + z): z ~ 1e-15 at capped xx rounds 1 + z
            # to 1 in float32, flushing delta to an exact 0 whose log is
            # -inf.
            delta_jj_5 = 0.4379 * jnp.log1p(1.3414 * xx ** (-0.7515))
            factor_q = f_m * (kk_1s / kk_2s + 6.0 * theta_e)
            # factor_v = (K0 - delta)/K2, computed in the e^x-scaled
            # frame: delta e^x overflows exactly when delta > K0, i.e.
            # when the reference's value would be negative and trapped to
            # 1 anyway (K0 < K2 makes > 1 impossible), so the log-space
            # comparison reproduces the trap
            # (simulation_coefficients.cpp:526-556) without ever forming
            # an inf.
            log_de = jnp.log(jnp.maximum(delta_jj_5, 1e-30)) + inv_theta
            log_k0s = jnp.log(kk_0s)
            ok_v = log_de <= log_k0s
            de = jnp.exp(jnp.minimum(log_de, log_k0s))
            factor_v = jnp.where(ok_v, (kk_0s - de) / kk_2s, 1.0)
        cold = theta_e < THETA_E_ZERO
        out["rho_q"] = coefficient_q * jnp.where(cold, 0.0, factor_q)
        out["rho_v"] = coefficient_v * jnp.where(cold, 1.0, factor_v)
    return out
