"""Cartesian Kerr-Schild (CKS) spacetime geometry, batched and differentiable.

Pure-jnp re-derivation of the closed-form CKS Kerr-Schild metric used for
geodesic integration in the reference (src/geodesic_integrator/
geodesic_geometry.cpp:19-276). Everything here broadcasts over arbitrary
leading batch dimensions: positions are ``(..., 3)`` spatial CKS coordinates
``(x, y, z)``; metrics come back as ``(..., 4, 4)``.

Unlike the reference's scalar per-pixel loops, these functions are the
vocabulary of vmapped/sharded batch math and are automatically
jax.grad-differentiable (including with respect to black-hole spin).

Conventions: metric signature (-,+,+,+); geometrized units G = c = 1 with
bh_m the black-hole mass (always 1.0 in the pipeline); indices are ordered
(t, x, y, z). The Kerr-Schild form is g_{munu} = eta_{munu} + f l_mu l_nu
with null covector l and scalar f = 2 M r^3 / (r^4 + a^2 z^2).
"""

from __future__ import annotations

import jax.numpy as jnp

from blacklight.constants import HIGHEST

__all__ = [
    "radius",
    "ks_scalars",
    "gcov",
    "gcon",
    "dgcon",
    "gcov_gcon",
    "null_momentum_time_component",
    "renormalize_null_momentum",
    "minkowski",
]


def radius(x, spin):
    """Kerr-Schild radial coordinate r(x, y, z).

    Solves r^4 - r^2 (|x|^2 - a^2) - a^2 z^2 = 0 for the positive root
    (reference geodesic_geometry.cpp:19-26).

    Args:
      x: (..., 3) CKS spatial coordinates.
      spin: black-hole spin a (scalar).

    Returns:
      (...) radial coordinate.
    """
    a2 = spin * spin
    rr2 = jnp.sum(x * x, axis=-1)
    z = x[..., 2]
    r2 = 0.5 * (rr2 - a2 + jnp.hypot(rr2 - a2, 2.0 * spin * z))
    return jnp.sqrt(r2)


def ks_scalars(x, spin, mass=1.0):
    """Common Kerr-Schild intermediates.

    Returns:
      (r, f, l_lower) where r is (...,), f is (...,), and l_lower is the
      spatial part (l_1, l_2, l_3) of the null covector, shape (..., 3).
      The time components are l_0 = 1 (covariant) and l^0 = -1 (index
      raised by eta), handled by callers.
    """
    a2 = spin * spin
    rr2 = jnp.sum(x * x, axis=-1)
    z = x[..., 2]
    r2 = 0.5 * (rr2 - a2 + jnp.hypot(rr2 - a2, 2.0 * spin * z))
    r = jnp.sqrt(r2)
    f = 2.0 * mass * r2 * r / (r2 * r2 + a2 * z * z)
    denom = r2 + a2
    lx = (r * x[..., 0] + spin * x[..., 1]) / denom
    ly = (r * x[..., 1] - spin * x[..., 0]) / denom
    lz = z / r
    l_lower = jnp.stack([lx, ly, lz], axis=-1)
    return r, f, l_lower


def minkowski(batch_shape, dtype):
    """Minkowski metric eta = diag(-1, 1, 1, 1) broadcast to batch_shape."""
    eta = jnp.diag(jnp.array([-1.0, 1.0, 1.0, 1.0], dtype=dtype))
    return jnp.broadcast_to(eta, tuple(batch_shape) + (4, 4))


def _l_four(l_lower, time_component):
    """Assemble 4-vector (time_component, l_1, l_2, l_3)."""
    t = jnp.full(l_lower.shape[:-1] + (1,), time_component, dtype=l_lower.dtype)
    return jnp.concatenate([t, l_lower], axis=-1)


def gcov(x, spin, mass=1.0, flat=False):
    """Covariant CKS metric g_{munu} (reference geodesic_geometry.cpp:38-93).

    Args:
      x: (..., 3) CKS coordinates.
      spin: spin a. mass: M. flat: if True return Minkowski (ray_flat mode).

    Returns:
      (..., 4, 4) metric components.
    """
    if flat:
        return minkowski(x.shape[:-1], x.dtype)
    _, f, l_lower = ks_scalars(x, spin, mass)
    l_cov = _l_four(l_lower, 1.0)  # l_mu with l_0 = 1
    eta = minkowski(x.shape[:-1], x.dtype)
    return eta + f[..., None, None] * l_cov[..., :, None] * l_cov[..., None, :]


def gcon(x, spin, mass=1.0, flat=False):
    """Contravariant CKS metric g^{munu} (reference geodesic_geometry.cpp:105-161)."""
    if flat:
        return minkowski(x.shape[:-1], x.dtype)
    _, f, l_lower = ks_scalars(x, spin, mass)
    l_con = _l_four(l_lower, -1.0)  # l^mu with l^0 = -1
    eta = minkowski(x.shape[:-1], x.dtype)
    return eta - f[..., None, None] * l_con[..., :, None] * l_con[..., None, :]


def gcov_gcon(x, spin, mass=1.0, flat=False):
    """Both metrics with shared intermediates (cheaper than two calls)."""
    if flat:
        eta = minkowski(x.shape[:-1], x.dtype)
        return eta, eta
    _, f, l_lower = ks_scalars(x, spin, mass)
    l_cov = _l_four(l_lower, 1.0)
    l_con = _l_four(l_lower, -1.0)
    eta = minkowski(x.shape[:-1], x.dtype)
    g_cov = eta + f[..., None, None] * l_cov[..., :, None] * l_cov[..., None, :]
    g_con = eta - f[..., None, None] * l_con[..., :, None] * l_con[..., None, :]
    return g_cov, g_con


def dgcon(x, spin, mass=1.0, flat=False):
    """Analytic spatial derivatives d(g^{munu})/d(x^i).

    Re-derivation of reference geodesic_geometry.cpp:173-276 in batched form:
    dgcon[..., i, mu, nu] = -(df_i l^mu l^nu + f dl^mu_i l^nu + f l^mu dl^nu_i).

    Returns:
      (..., 3, 4, 4) derivative components (index i over x, y, z).
    """
    if flat:
        return jnp.zeros(x.shape[:-1] + (3, 4, 4), dtype=x.dtype)

    a2 = spin * spin
    xx, yy, z = x[..., 0], x[..., 1], x[..., 2]
    rr2 = jnp.sum(x * x, axis=-1)
    r2 = 0.5 * (rr2 - a2 + jnp.hypot(rr2 - a2, 2.0 * spin * z))
    r = jnp.sqrt(r2)
    f = 2.0 * mass * r2 * r / (r2 * r2 + a2 * z * z)
    denom = r2 + a2

    l1 = (r * xx + spin * yy) / denom
    l2 = (r * yy - spin * xx) / denom
    l3 = z / r
    # l^mu with l^0 = -1
    l_con = jnp.stack([-jnp.ones_like(l1), l1, l2, l3], axis=-1)

    # Scalar derivatives (geodesic_geometry.cpp:200-206)
    dr_denom = 2.0 * r2 - rr2 + a2
    dr_dx = r * xx / dr_denom
    dr_dy = r * yy / dr_denom
    dr_dz = (r * z + a2 * z / r) / dr_denom
    f_denom = r * (r2 * r2 + a2 * z * z)
    poly = r2 * r2 - 3.0 * a2 * z * z
    df_dx = -poly * dr_dx / f_denom * f
    df_dy = -poly * dr_dy / f_denom * f
    df_dz = -(poly * dr_dz + 2.0 * a2 * r * z) / f_denom * f
    df = jnp.stack([df_dx, df_dy, df_dz], axis=-1)  # (..., 3)

    # Vector derivatives dl^mu/dx^i (geodesic_geometry.cpp:209-220)
    zero = jnp.zeros_like(l1)
    dl1 = jnp.stack([
        ((xx - 2.0 * r * l1) * dr_dx + r) / denom,
        ((xx - 2.0 * r * l1) * dr_dy + spin) / denom,
        (xx - 2.0 * r * l1) * dr_dz / denom,
    ], axis=-1)
    dl2 = jnp.stack([
        ((yy - 2.0 * r * l2) * dr_dx - spin) / denom,
        ((yy - 2.0 * r * l2) * dr_dy + r) / denom,
        (yy - 2.0 * r * l2) * dr_dz / denom,
    ], axis=-1)
    dl3 = jnp.stack([
        -z / r2 * dr_dx,
        -z / r2 * dr_dy,
        -z / r2 * dr_dz + 1.0 / r,
    ], axis=-1)
    dl0 = jnp.stack([zero, zero, zero], axis=-1)
    # dl[..., i, mu]
    dl = jnp.stack([dl0, dl1, dl2, dl3], axis=-1)  # (..., 3, 4)

    # dgcon[..., i, mu, nu]
    ll = l_con[..., :, None] * l_con[..., None, :]              # (..., 4, 4)
    term_f = df[..., :, None, None] * ll[..., None, :, :]       # (..., 3, 4, 4)
    term_l = (dl[..., :, :, None] * l_con[..., None, None, :]
              + l_con[..., None, :, None] * dl[..., :, None, :])
    return -(term_f + f[..., None, None, None] * term_l)


def ks_derivatives(x, spin, mass=1.0):
    """Scalar Kerr-Schild intermediates + their spatial derivatives.

    The accelerator factorization: because g^{munu} = eta^{munu} - f l^mu l^nu
    is rank-1 off Minkowski, every metric contraction in the geodesic RHS
    reduces to a handful of (B,)-shaped scalar ops - no (B,4,4) or (B,3,4,4)
    tensors, whose tiny trailing dims would waste most of each vector
    register or thread's work. Same closed forms as the reference
    (geodesic_geometry.cpp:173-276), just never materialized as tensors.

    Returns:
      (r, f, (l1,l2,l3), (df_dx,df_dy,df_dz),
       (dl1, dl2, dl3)) where dli is a 3-tuple of d(l_i)/d(x,y,z).
    """
    a2 = spin * spin
    xx, yy, z = x[..., 0], x[..., 1], x[..., 2]
    rr2 = xx * xx + yy * yy + z * z
    r2 = 0.5 * (rr2 - a2 + jnp.hypot(rr2 - a2, 2.0 * spin * z))
    r = jnp.sqrt(r2)
    f = 2.0 * mass * r2 * r / (r2 * r2 + a2 * z * z)
    denom = r2 + a2
    l1 = (r * xx + spin * yy) / denom
    l2 = (r * yy - spin * xx) / denom
    l3 = z / r

    dr_denom = 2.0 * r2 - rr2 + a2
    dr_dx = r * xx / dr_denom
    dr_dy = r * yy / dr_denom
    dr_dz = (r * z + a2 * z / r) / dr_denom
    f_denom = r * (r2 * r2 + a2 * z * z)
    poly = r2 * r2 - 3.0 * a2 * z * z
    df_dx = -poly * dr_dx / f_denom * f
    df_dy = -poly * dr_dy / f_denom * f
    df_dz = -(poly * dr_dz + 2.0 * a2 * r * z) / f_denom * f

    c1 = (xx - 2.0 * r * l1) / denom
    c2 = (yy - 2.0 * r * l2) / denom
    dl1 = (c1 * dr_dx + r / denom, c1 * dr_dy + spin / denom, c1 * dr_dz)
    dl2 = (c2 * dr_dx - spin / denom, c2 * dr_dy + r / denom, c2 * dr_dz)
    dl3 = (-z / r2 * dr_dx, -z / r2 * dr_dy, -z / r2 * dr_dz + 1.0 / r)
    return r, f, (l1, l2, l3), (df_dx, df_dy, df_dz), (dl1, dl2, dl3)


def ks_derivatives_c(xx, yy, z, spin, mass=1.0):
    """Component-input form of :func:`ks_derivatives` (same math, no
    trailing-axis packing - consumable by scalarized callers where small
    trailing dims would waste vector work)."""
    a2 = spin * spin
    rr2 = xx * xx + yy * yy + z * z
    r2 = 0.5 * (rr2 - a2 + jnp.hypot(rr2 - a2, 2.0 * spin * z))
    r = jnp.sqrt(r2)
    f = 2.0 * mass * r2 * r / (r2 * r2 + a2 * z * z)
    denom = r2 + a2
    l1 = (r * xx + spin * yy) / denom
    l2 = (r * yy - spin * xx) / denom
    l3 = z / r

    dr_denom = 2.0 * r2 - rr2 + a2
    dr_dx = r * xx / dr_denom
    dr_dy = r * yy / dr_denom
    dr_dz = (r * z + a2 * z / r) / dr_denom
    f_denom = r * (r2 * r2 + a2 * z * z)
    poly = r2 * r2 - 3.0 * a2 * z * z
    df_dx = -poly * dr_dx / f_denom * f
    df_dy = -poly * dr_dy / f_denom * f
    df_dz = -(poly * dr_dz + 2.0 * a2 * r * z) / f_denom * f

    c1 = (xx - 2.0 * r * l1) / denom
    c2 = (yy - 2.0 * r * l2) / denom
    dl1 = (c1 * dr_dx + r / denom, c1 * dr_dy + spin / denom, c1 * dr_dz)
    dl2 = (c2 * dr_dx - spin / denom, c2 * dr_dy + r / denom, c2 * dr_dz)
    dl3 = (-z / r2 * dr_dx, -z / r2 * dr_dy, -z / r2 * dr_dz + 1.0 / r)
    return r, f, (l1, l2, l3), (df_dx, df_dy, df_dz), (dl1, dl2, dl3)


def geodesic_rhs_c(x1, x2, x3, p0, p1, p2, p3, spin, mass=1.0, flat=False,
                   with_distance=False):
    """Component-form geodesic RHS.

    Returns (dx0, dx1, dx2, dx3, dp1, dp2, dp3[, ds]) - dp0 = 0 always.
    """
    if flat:
        zero = jnp.zeros_like(p0)
        out = (-p0, p1, p2, p3, zero, zero, zero)
        if not with_distance:
            return out
        return out + (-jnp.sqrt(p1 * p1 + p2 * p2 + p3 * p3),)

    r, f, (l1, l2, l3), df, (dl1, dl2, dl3) = ks_derivatives_c(
        x1, x2, x3, spin, mass)
    lp = -p0 + l1 * p1 + l2 * p2 + l3 * p3  # l^mu p_mu
    flp = f * lp
    k0 = -p0 + flp          # g^{0nu} p_nu (l^0 = -1)
    k1 = p1 - flp * l1
    k2 = p2 - flp * l2
    k3 = p3 - flp * l3
    dlp1 = dl1[0] * p1 + dl2[0] * p2 + dl3[0] * p3
    dlp2 = dl1[1] * p1 + dl2[1] * p2 + dl3[1] * p3
    dlp3 = dl1[2] * p1 + dl2[2] * p2 + dl3[2] * p3
    half_lp2 = 0.5 * lp * lp
    dp1 = df[0] * half_lp2 + flp * dlp1
    dp2 = df[1] * half_lp2 + flp * dlp2
    dp3 = df[2] * half_lp2 + flp * dlp3
    out = (k0, k1, k2, k3, dp1, dp2, dp3)
    if not with_distance:
        return out
    scale = f * k0 / (-1.0 - f)
    q1 = k1 - scale * l1
    q2 = k2 - scale * l2
    q3 = k3 - scale * l3
    lq = l1 * q1 + l2 * q2 + l3 * q3
    ds2 = q1 * q1 + q2 * q2 + q3 * q3 + f * lq * lq
    # Floor strictly above 0: d(sqrt)/dx at a 0-clamp is inf, and inf * 0
    # adjoints NaN-poison reverse-mode through the scan.
    ds = -jnp.sqrt(jnp.maximum(ds2, 1e-300))
    return out + (ds,)


def geodesic_rhs_scalar(y, spin, mass=1.0, flat=False, with_distance=False):
    """Geodesic ODE right-hand side in scalarized Kerr-Schild form.

    Algebraically identical to :func:`blacklight.ops.geodesic.geodesic_rhs`
    (reference geodesics.cpp:867-925), using the rank-1 structure:
      dx^mu/dlambda = eta^{munu} p_nu - f l^mu (l.p)
      dp_i /dlambda = +1/2 [ df_i (l.p)^2 + 2 f (l.p) (dl_i . p) ]
      ds   /dlambda = -sqrt(|q|^2 + f (l.q)^2),
        q^a = k^a - f l_a k^0 / (-1 - f)
    with (l.p) = -p_0 + l_i p_i (index raised by eta).
    """
    comps = geodesic_rhs_c(y[..., 1], y[..., 2], y[..., 3], y[..., 4],
                           y[..., 5], y[..., 6], y[..., 7], spin, mass,
                           flat=flat, with_distance=with_distance)
    zero = jnp.zeros_like(comps[0])
    packed = [comps[0], comps[1], comps[2], comps[3], zero,
              comps[4], comps[5], comps[6]]
    if with_distance:
        packed.append(comps[7])
    return jnp.stack(packed, axis=-1)


def renormalize_factor_c(x1, x2, x3, p0, p1, p2, p3, spin, mass=1.0,
                         flat=False):
    """Component-form spatial momentum rescale factor for null
    renormalization (see :func:`renormalize_null_momentum_scalar`)."""
    if flat:
        a = p1 * p1 + p2 * p2 + p3 * p3
        b = jnp.zeros_like(p0)
        c = -p0 * p0
    else:
        a2s = spin * spin
        rr2 = x1 * x1 + x2 * x2 + x3 * x3
        r2 = 0.5 * (rr2 - a2s + jnp.hypot(rr2 - a2s, 2.0 * spin * x3))
        r = jnp.sqrt(r2)
        f = 2.0 * mass * r2 * r / (r2 * r2 + a2s * x3 * x3)
        denom = r2 + a2s
        l1 = (r * x1 + spin * x2) / denom
        l2 = (r * x2 - spin * x1) / denom
        l3 = x3 / r
        lsps = l1 * p1 + l2 * p2 + l3 * p3
        a = p1 * p1 + p2 * p2 + p3 * p3 - f * lsps * lsps
        b = 2.0 * f * lsps * p0
        c = -(1.0 + f) * p0 * p0
    d = jnp.sqrt(jnp.maximum(b * b - 4.0 * a * c, 1e-300))
    use_neg = b < 0.0
    num = jnp.where(use_neg, d - b, -2.0 * c)
    den = jnp.where(use_neg, 2.0 * a, b + d)
    # Backward-traced momenta diverge at the horizon, where float32 can
    # cancel a to exactly 0: keep that step's momentum unrenormalized
    # rather than infinite.
    ok = den != 0.0
    return jnp.where(ok, num / jnp.where(ok, den, 1.0), 1.0)


def renormalize_null_momentum_scalar(x, p_cov, spin, mass=1.0, flat=False):
    """Scalarized null renormalization (same math as
    :func:`renormalize_null_momentum`, reference geodesics.cpp:295-309):
      a = |p_s|^2 - f (l_s.p_s)^2
      b = 2 f (l_s.p_s) p_0
      c = -(1 + f) p_0^2
    choosing the stable quadratic branch for the spatial scale factor.
    """
    factor = renormalize_factor_c(
        x[..., 0], x[..., 1], x[..., 2], p_cov[..., 0], p_cov[..., 1],
        p_cov[..., 2], p_cov[..., 3], spin, mass, flat=flat)
    return jnp.concatenate([p_cov[..., 0:1], p_cov[..., 1:] * factor[..., None]],
                           axis=-1)


def null_momentum_time_component(g_cov, p_spatial):
    """Solve g_{munu} p^mu p^nu = 0 for p^0 given contravariant spatial p^i.

    Root selection matches the reference camera setup
    (src/geodesic_integrator/camera.cpp:554-566): outside the ergosphere take
    the unique positive root; inside (g_00 -> 0 or > 0 with g_{0i} p^i < 0)
    take the branch that stays finite.

    Args:
      g_cov: (..., 4, 4) covariant metric.
      p_spatial: (..., 3) contravariant spatial momentum.

    Returns:
      (...) contravariant time component p^0.
    """
    a = g_cov[..., 0, 0]
    b = 2.0 * jnp.einsum("...i,...i->...", g_cov[..., 0, 1:], p_spatial,
                         precision=HIGHEST)
    c = jnp.einsum("...ij,...i,...j->...", g_cov[..., 1:, 1:], p_spatial,
                   p_spatial, precision=HIGHEST)
    d = jnp.sqrt(jnp.maximum(b * b - 4.0 * a * c, 0.0))
    root_bneg = 2.0 * c / (d - b)
    root_else = -(b + d) / (2.0 * a)
    root = jnp.where(b < 0.0, root_bneg, root_else)
    degenerate = -c / (2.0 * b)
    return jnp.where(a == 0.0, degenerate, root)


def renormalize_null_momentum(g_con, p_cov):
    """Rescale spatial covariant momentum so g^{munu} p_mu p_nu = 0.

    Matches the per-step renormalization of the reference integrators
    (src/geodesic_integrator/geodesics.cpp:295-309): solve
    a s^2 + b s + c = 0 for the scale s on (p_1, p_2, p_3), keeping p_0,
    with a = g^{ij} p_i p_j, b = 2 g^{0i} p_0 p_i, c = g^{00} p_0^2,
    choosing the numerically stable branch.

    Args:
      g_con: (..., 4, 4) contravariant metric.
      p_cov: (..., 4) covariant momentum.

    Returns:
      (..., 4) renormalized covariant momentum.
    """
    p0 = p_cov[..., 0]
    ps = p_cov[..., 1:]
    a = jnp.einsum("...ij,...i,...j->...", g_con[..., 1:, 1:], ps, ps,
                   precision=HIGHEST)
    b = 2.0 * p0 * jnp.einsum("...i,...i->...", g_con[..., 0, 1:], ps,
                              precision=HIGHEST)
    c = g_con[..., 0, 0] * p0 * p0
    d = jnp.sqrt(jnp.maximum(b * b - 4.0 * a * c, 0.0))
    factor = jnp.where(b < 0.0, (d - b) / (2.0 * a), -2.0 * c / (b + d))
    return jnp.concatenate([p0[..., None], ps * factor[..., None]], axis=-1)
