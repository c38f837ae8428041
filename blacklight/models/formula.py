"""Analytic power-law disk emission model of 2020 ApJ 897 148.

Batched re-derivation of the reference formula coefficients
(src/radiation_integrator/formula_coefficients.cpp:25-183): for each sample
the Boyer-Lindquist metric, the disk angular-momentum profile ell(r), the
normalized 4-velocity, a Gaussian density profile, and per-frequency
invariant emission/absorption coefficients

  j_invariant     = j_nu / nu^2        (reference stores j_nu/nu^2; the final
                                        image applies the nu^3 scaling)
  alpha_invariant = alpha_nu * nu

All cuts (camera radius, near/far plane, spheres, midplane, arbitrary plane)
become masks that zero the coefficients, exactly as the reference's
``continue`` leaves the zero-initialized arrays untouched.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from blacklight.ops import geometry


@dataclasses.dataclass(frozen=True)
class FormulaParams:
    """Model + cut parameters (Python scalars; all static under jit except
    the jnp-traced physics parameters when differentiating)."""

    bh_m: float
    bh_a: float
    camera_r: float
    # Formula model (input_reader.hpp:59-69)
    mass: float
    r0: float
    h: float
    l0: float
    q: float
    nup: float
    cn0: float
    alpha: float
    beta: float
    a_param: float
    # Cuts (only the geometric ones apply to the formula model)
    cut_omit_near: bool = False
    cut_omit_far: bool = False
    cut_omit_in: float = -1.0
    cut_omit_out: float = -1.0
    cut_midplane_theta: float = 0.0
    cut_midplane_z: float = 0.0
    cut_plane: bool = False
    cut_plane_origin: tuple = (0.0, 0.0, 0.0)
    cut_plane_normal: tuple = (0.0, 0.0, 1.0)


def formula_coefficients(pos, kcov, momentum_factors, frequencies,
                         params: FormulaParams, camera_x):
    """Invariant j and alpha for a batch of samples.

    Args:
      pos: (B, 4) sample positions (CKS).
      kcov: (B, 4) covariant photon momenta.
      momentum_factors: (B,) per-ray frequency normalization.
      frequencies: (F,) image frequencies in Hz.
      params: model parameters.
      camera_x: (4,) camera position (for near/far cuts).

    Returns:
      (j, alpha, keep, bad): j is the invariant emission coefficient IN
      UNITS OF cn0/nup^2 (so values stay O(1) and survive float32; multiply
      the final image by j_scale = cn0/nup^2); alpha is the unscaled
      invariant absorption; keep is the (B,) sample mask after cuts; bad is
      the (B, F) mask of samples where the C++ computation would produce
      NaN (pow of a negative base with non-integer exponent, non-timelike
      rotation profile). j/alpha carry finite placeholder values there -
      never NaN primals, whose adjoints would poison reverse-mode through
      any product - and the transfer NaN-poisons flagged pixels instead.
    """
    x, y, z = pos[..., 1], pos[..., 2], pos[..., 3]
    xyz = pos[..., 1:4]
    bh_m, bh_a = params.bh_m, params.bh_a

    r = geometry.radius(xyz, bh_a)

    # Cuts (formula_coefficients.cpp:73-116)
    keep = r <= params.camera_r
    if params.cut_omit_near or params.cut_omit_far:
        dot = x * camera_x[1] + y * camera_x[2] + z * camera_x[3]
        if params.cut_omit_near:
            keep &= ~(dot > 0.0)
        if params.cut_omit_far:
            keep &= ~(dot < 0.0)
    if params.cut_omit_in >= 0.0:
        keep &= ~(r < params.cut_omit_in)
    if params.cut_omit_out >= 0.0:
        keep &= ~(r > params.cut_omit_out)
    if params.cut_midplane_theta != 0.0:
        th = jnp.arccos(z / r)
        off = jnp.abs(th - jnp.pi / 2.0)
        if params.cut_midplane_theta > 0.0:
            keep &= ~(off > params.cut_midplane_theta)
        else:
            keep &= ~(off < -params.cut_midplane_theta)
    if params.cut_midplane_z != 0.0:
        if params.cut_midplane_z > 0.0:
            keep &= ~(jnp.abs(z) > params.cut_midplane_z)
        else:
            keep &= ~(jnp.abs(z) < -params.cut_midplane_z)
    if params.cut_plane:
        ox, oy, oz = params.cut_plane_origin
        nx, ny, nz = params.cut_plane_normal
        dot = (x - ox) * nx + (y - oy) * ny + (z - oz) * nz
        keep &= ~(dot < 0.0)

    # Curvilinear (Boyer-Lindquist-like) coordinates (cpp:118-124).
    # sin^2(theta) = (x^2 + y^2) / (r^2 + a^2) is the Kerr-Schild identity
    # behind the reference's 1 - (z/r)^2; it does not cancel near the axis,
    # where float32 1 - cth^2 rounds to 0 within ~3e-4 r of it.
    cth = z / r
    sth2 = (x * x + y * y) / (r * r + bh_a * bh_a)
    on_axis = ~(sth2 > 0.0)
    sth = jnp.where(on_axis, 0.0, jnp.sqrt(jnp.where(on_axis, 1.0, sth2)))
    rr = r * sth
    ph = jnp.arctan2(y, x) - jnp.arctan(bh_a / r)
    sph = jnp.sin(ph)
    cph = jnp.cos(ph)

    # BL metric (cpp:126-133). At the horizon (delta = 0) or on the axis
    # (sin theta = 0) the reference divides by zero and its pixel turns NaN:
    # flag those samples bad and divide by finite placeholders, so no
    # non-finite primal reaches reverse mode.
    delta = r * r - 2.0 * bh_m * r + bh_a * bh_a
    singular = (delta == 0.0) | on_axis
    delta_s = jnp.where(delta == 0.0, 1.0, delta)
    sigma = r * r + bh_a * bh_a * cth * cth
    gtt_bl = -(1.0 + 2.0 * bh_m * r * (r * r + bh_a * bh_a)
               / (delta_s * sigma))
    gtph_bl = -2.0 * bh_m * bh_a * r / (delta_s * sigma)
    grr_bl = delta / sigma
    gthth_bl = 1.0 / sigma
    gphph_bl = (sigma - 2.0 * bh_m * r) / (delta_s * sigma
                                           * jnp.where(on_axis, 1.0, sth2))

    # Angular momentum profile ell(r) (C 6; cpp:135-136)
    ll = params.l0 / (1.0 + rr) * jnp.power(rr, 1.0 + params.q)

    # 4-velocity (C 7-8; cpp:138-157): BL covariant -> BL contravariant ->
    # KS contravariant -> CKS contravariant
    # Forward NaN for non-timelike arguments matches C++ sqrt(neg); the
    # double-where keeps gradients finite.
    u_arg = -gtt_bl + 2.0 * gtph_bl * ll - gphph_bl * ll * ll
    # Non-timelike profile (C++ sqrt(neg) -> NaN): finite placeholder +
    # bad flag; a NaN primal here would enter products and poison adjoints
    bad = ~(u_arg > 0.0) | singular
    u_norm = 1.0 / jnp.sqrt(jnp.where(u_arg > 0.0, u_arg, 1.0))
    u_t_bl = -u_norm
    u_ph_bl = u_norm * ll
    ut_bl = gtt_bl * u_t_bl + gtph_bl * u_ph_bl
    ur_bl = grr_bl * 0.0
    uth_bl = gthth_bl * 0.0
    uph_bl = gtph_bl * u_t_bl + gphph_bl * u_ph_bl
    ut = ut_bl + 2.0 * bh_m * r / delta_s * ur_bl
    ur = ur_bl
    uth = uth_bl
    uph = uph_bl + bh_a / delta_s * ur_bl
    u0 = ut
    u1 = (sth * cph * ur + cth * (r * cph - bh_a * sph) * uth
          + sth * (-r * sph - bh_a * cph) * uph)
    u2 = (sth * sph * ur + cth * (r * sph + bh_a * cph) * uth
          + sth * (r * cph - bh_a * sph) * uph)
    u3 = cth * ur - r * sth * uth

    # Fluid-frame density (C 5; cpp:159-162)
    n_n0 = jnp.exp(-0.5 * (r * r / (params.r0 * params.r0)
                           + params.h * params.h * cth * cth))

    # Per-frequency coefficients (C 9-12; cpp:164-179)
    u_dot_k = (u0 * kcov[..., 0] + u1 * kcov[..., 1]
               + u2 * kcov[..., 2] + u3 * kcov[..., 3])
    nu_fluid = -u_dot_k[..., None] * frequencies[None, :] * momentum_factors[..., None]
    # x = nu/nup is O(1); j_invariant = (cn0/nup^2) * n * x^(-alpha-2).
    # Near the horizon nu_fluid can go negative for the formula 4-velocity;
    # the reference feeds that into std::pow, which returns a signed value
    # for integer-valued exponents and NaN otherwise - match it with
    # gradient-safe internals (_cpp_pow).
    x_raw = nu_fluid / params.nup
    pow_j, bad_j = _cpp_pow(x_raw, -params.alpha - 2.0)
    pow_a, bad_a = _cpp_pow(x_raw, -params.beta - params.alpha)
    j_scaled = n_n0[..., None] * pow_j
    alpha_fluid = params.a_param * params.cn0 * n_n0[..., None] * pow_a
    alpha_invariant = alpha_fluid * nu_fluid
    keep = jnp.broadcast_to(keep[..., None], j_scaled.shape)
    # NaN j poisons the pixel (the reference's I += j dl propagates it);
    # NaN alpha alone does NOT - the reference's alpha > 0 test is false
    # for NaN, routing to the j-only branch (unpolarized.cpp:98-110) - so
    # alpha is zeroed instead (identical forward I_nu).
    bad = (bad[..., None] | bad_j) & keep
    alpha_invariant = jnp.where(bad_a, 0.0, alpha_invariant)

    return (jnp.where(keep, j_scaled, 0.0),
            jnp.where(keep, alpha_invariant, 0.0),
            keep[..., 0], bad)


def _cpp_pow(x, e):
    """std::pow semantics for possibly-negative base, gradient-safe.

    C++: pow(neg, integer-valued e) = sign(neg)^e * |neg|^e; non-integer e
    gives NaN. jnp.power(neg, float) is NaN in both cases.

    Returns (value, bad): value is always a FINITE placeholder (|x|^e with
    the C++ sign for integer e) and bad marks entries where C++ would
    produce NaN. NaN is never materialized: a NaN primal entering any later
    product would make that product's other-factor adjoint 0 * NaN = NaN,
    poisoning reverse-mode for the whole batch reduction.
    """
    x_safe = jnp.where(x > 0.0, x, 1.0)
    pos = jnp.power(x_safe, e)
    xn_safe = jnp.where(x < 0.0, -x, 1.0)
    if isinstance(e, (int, float)) and float(e).is_integer():
        sign = -1.0 if int(e) % 2 else 1.0
        bad = jnp.zeros(jnp.shape(x), dtype=bool)
    else:
        sign = 1.0  # placeholder magnitude; flagged bad
        bad = x < 0.0
    neg = sign * jnp.power(xn_safe, e)
    # x == 0: pow only at actual zeros (0^e may be 0, 1, or inf; inf at
    # e < 0 is flagged rather than materialized)
    zero = jnp.power(jnp.where(x == 0.0, x, 1.0), e)
    if isinstance(e, (int, float)) and e < 0.0:
        bad = bad | (x == 0.0)
        zero = jnp.where(x == 0.0, 1.0, zero)
    val = jnp.where(x > 0.0, pos, jnp.where(x < 0.0, neg, zero))
    return val, bad


def formula_log_j_scale(params: FormulaParams):
    """log of the factor restoring CGS units of the scaled invariant j.

    Kept in log form: cn0/nup^2 ~ 1e-41 underflows float32."""
    return jnp.log(params.cn0) - 2.0 * jnp.log(params.nup)


def formula_params_from_config(cfg) -> FormulaParams:
    return FormulaParams(
        bh_m=1.0,
        bh_a=cfg.require("formula_spin"),
        camera_r=cfg.require("camera_r"),
        mass=cfg.require("formula_mass"),
        r0=cfg.require("formula_r0"),
        h=cfg.require("formula_h"),
        l0=cfg.require("formula_l0"),
        q=cfg.require("formula_q"),
        nup=cfg.require("formula_nup"),
        cn0=cfg.require("formula_cn0"),
        alpha=cfg.require("formula_alpha"),
        beta=cfg.require("formula_beta"),
        a_param=cfg.require("formula_a"),
        cut_omit_near=cfg.require("cut_omit_near"),
        cut_omit_far=cfg.require("cut_omit_far"),
        cut_omit_in=cfg.require("cut_omit_in"),
        cut_omit_out=cfg.require("cut_omit_out"),
        cut_midplane_theta=cfg.require("cut_midplane_theta"),
        cut_midplane_z=cfg.require("cut_midplane_z"),
        cut_plane=cfg.require("cut_plane"),
        cut_plane_origin=(cfg.cut_plane_origin_x or 0.0,
                          cfg.cut_plane_origin_y or 0.0,
                          cfg.cut_plane_origin_z or 0.0),
        cut_plane_normal=(cfg.cut_plane_normal_x or 0.0,
                          cfg.cut_plane_normal_y or 0.0,
                          cfg.cut_plane_normal_z or 0.0),
    )
