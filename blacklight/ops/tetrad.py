"""Orthonormal tetrad construction (reference radiation_geometry.cpp:597-658).

Batched: e_0 = u; e_3 along the projection of k orthogonal to u; e_2 along
the projection of `up` (usually b) orthogonal to e_0 and e_3; e_1 completes
a right-handed frame via the Levi-Civita contraction, assuming |det g| = 1
(true in Cartesian Kerr-Schild / Minkowski).

tetrad[..., a, mu] are contravariant components e_a^mu.
"""

from __future__ import annotations

import jax.numpy as jnp

from blacklight.constants import HIGHEST


def tetrad_cks(ucon, ucov, kcon, kcov, up_con, gcov, gcon):
    """Build the (B, 4, 4) tetrad; all args batched (B, ...)."""
    omega = -jnp.einsum("...m,...m->...", kcov, ucon, precision=HIGHEST)
    k_up = jnp.einsum("...m,...m->...", kcov, up_con,
                      precision=HIGHEST) / omega
    u_up = jnp.einsum("...m,...m->...", ucov, up_con,
                      precision=HIGHEST) / omega

    e0 = ucon
    e3 = kcon / omega[..., None] - ucon
    e2 = up_con - k_up[..., None] * e3 + u_up[..., None] * kcon
    norm = jnp.sqrt(jnp.einsum("...mn,...m,...n->...", gcov, e2, e2,
                               precision=HIGHEST))
    e2 = e2 / norm[..., None]

    # e_1 covariant via generalized cross product of e_0, e_2, e_3
    # (radiation_geometry.cpp:638-652)
    def lc_term(a, b, c):
        return (e0[..., a] * (e2[..., b] * e3[..., c] - e2[..., c] * e3[..., b]))

    e1_cov = jnp.stack([
        lc_term(1, 3, 2) + lc_term(2, 1, 3) + lc_term(3, 2, 1),
        lc_term(0, 2, 3) + lc_term(2, 3, 0) + lc_term(3, 0, 2),
        lc_term(0, 3, 1) + lc_term(1, 0, 3) + lc_term(3, 1, 0),
        lc_term(0, 1, 2) + lc_term(1, 2, 0) + lc_term(2, 0, 1),
    ], axis=-1)
    e1 = jnp.einsum("...mn,...n->...m", gcon, e1_cov, precision=HIGHEST)
    return jnp.stack([e0, e1, e2, e3], axis=-2)


def tetrad_rows_c(ucon, kcon, kcov, up_con, f, l_cov, ucov=None):
    """Scalarized tetrad rows for the polarized transfer hot path.

    Same construction as :func:`tetrad_cks`, but on component tuples with
    the metric applied through its rank-1 Kerr-Schild structure
    g_{mn} = eta_{mn} + f l_m l_n (no (B, 4, 4) tensors): only rows 1 and
    2 feed the Stokes conversions, so only they are returned - both the
    contravariant components and the covariant ones (e1's covariant form
    falls out of the Levi-Civita completion for free, saving a lowering).

    Args:
      ucon, kcon, up_con: 4-tuples of contravariant components.
      kcov: 4-tuple of covariant components.
      f: (...,) Kerr-Schild scalar (0 for flat spacetime).
      l_cov: (l1, l2, l3) spatial covariant null-vector components
        (l_0 = 1; ignored when f == 0... pass zeros for flat).
      ucov: optional explicit covariant u components - the camera-frame
        extraction passes the camera's own u_cov (broadcast per pixel,
        matching the reference's use of the camera-center velocity,
        polarized.cpp:873-939) rather than lowering ucon at each pixel's
        position.

    Returns (t1, t2, e1_cov, e2_cov), each a 4-tuple of (...,) arrays.
    """
    l1, l2, l3 = l_cov

    def ldot(v):
        # l_m v^m with covariant l = (1, l1, l2, l3)
        return v[0] + l1 * v[1] + l2 * v[2] + l3 * v[3]

    def cov(v):
        # g_{mn} v^n = eta v + f l_m (l.v)
        lv = f * ldot(v)
        return (-v[0] + lv, v[1] + l1 * lv, v[2] + l2 * lv, v[3] + l3 * lv)

    def con(w):
        # g^{mn} w_n = eta w - f l^m (l^n w_n), l^m = (-1, l1, l2, l3)
        lw = f * (-w[0] + l1 * w[1] + l2 * w[2] + l3 * w[3])
        return (-w[0] + lw, w[1] - l1 * lw, w[2] - l2 * lw, w[3] - l3 * lw)

    def dot4(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3]

    def inner(a, b):
        return (-a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3]
                + f * ldot(a) * ldot(b))

    omega = -dot4(kcov, ucon)
    k_up = dot4(kcov, up_con) / omega
    if ucov is None:
        ucov = cov(ucon)
    u_up = dot4(ucov, up_con) / omega

    e0 = ucon
    e3 = tuple(kcon[m] / omega - ucon[m] for m in range(4))
    e2 = tuple(up_con[m] - k_up * e3[m] + u_up * kcon[m] for m in range(4))
    norm = jnp.sqrt(inner(e2, e2))
    e2 = tuple(c / norm for c in e2)

    def lc_term(a, b, c):
        return e0[a] * (e2[b] * e3[c] - e2[c] * e3[b])

    e1_cov = (
        lc_term(1, 3, 2) + lc_term(2, 1, 3) + lc_term(3, 2, 1),
        lc_term(0, 2, 3) + lc_term(2, 3, 0) + lc_term(3, 0, 2),
        lc_term(0, 3, 1) + lc_term(1, 0, 3) + lc_term(3, 1, 0),
        lc_term(0, 1, 2) + lc_term(1, 2, 0) + lc_term(2, 0, 1),
    )
    e1 = con(e1_cov)
    e2_cov = cov(e2)
    return e1, e2, e1_cov, e2_cov
