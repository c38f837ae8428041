"""CKS Christoffel connection, batched (reference radiation_geometry.cpp:274-410).

Built from the Kerr-Schild covariant derivative dg_{munu}/dx^i =
df_i l_mu l_nu + f (dl_i,mu l_nu + l_mu dl_i,nu) with covariant
l = (1, l1, l2, l3), dl_,0 = 0 and no time dependence.
"""

from __future__ import annotations

import jax.numpy as jnp

from blacklight.ops import geometry

from blacklight.constants import HIGHEST


def dgcov_cks(x, spin, mass=1.0, flat=False):
    """Spatial derivatives of the covariant metric: (..., 4[d], 4, 4)
    with d = (t, x, y, z); the time slot is zero."""
    if flat:
        return jnp.zeros(x.shape[:-1] + (4, 4, 4), dtype=x.dtype)
    r, f, (l1, l2, l3), df, (dl1, dl2, dl3) = geometry.ks_derivatives(x, spin, mass)
    one = jnp.ones_like(l1)
    zero = jnp.zeros_like(l1)
    l_cov = jnp.stack([one, l1, l2, l3], axis=-1)                 # (..., 4)
    df_v = jnp.stack([zero, df[0], df[1], df[2]], axis=-1)        # (..., 4) incl t
    # dl[..., d, mu]: derivative of covariant l_mu along direction d (t,x,y,z)
    dl = jnp.stack([
        jnp.stack([zero, zero, zero, zero], axis=-1),
        jnp.stack([zero, dl1[0], dl2[0], dl3[0]], axis=-1),
        jnp.stack([zero, dl1[1], dl2[1], dl3[1]], axis=-1),
        jnp.stack([zero, dl1[2], dl2[2], dl3[2]], axis=-1),
    ], axis=-2)                                                   # (..., 4, 4)
    ll = l_cov[..., :, None] * l_cov[..., None, :]
    term_f = df_v[..., :, None, None] * ll[..., None, :, :]
    term_l = f[..., None, None, None] * (
        dl[..., :, :, None] * l_cov[..., None, None, :]
        + l_cov[..., None, :, None] * dl[..., :, None, :])
    return term_f + term_l


def connection_cks(x, spin, mass=1.0, flat=False):
    """Christoffel symbols Gamma^mu_{alpha beta}: (..., 4, 4, 4)."""
    dg = dgcov_cks(x, spin, mass, flat=flat)
    g_con = geometry.gcon(x, spin, mass, flat=flat)
    # Gamma^mu_ab = 1/2 g^{mu d} (dg[a, d, b] + dg[b, d, a] - dg[d, a, b])
    term = (jnp.einsum("...adb->...dab", dg) + jnp.einsum("...bda->...dab", dg)
            - dg)
    return 0.5 * jnp.einsum("...md,...dab->...mab", g_con, term,
                            precision=HIGHEST)


def transport_matrix_c(x1, x2, x3, k0, k1, k2, k3, spin, mass=1.0,
                       flat=False, derivs=None):
    """Scalarized parallel-transport matrix A^m_b = k^a Gamma^m_{ab}.

    The contraction the polarized transport needs
    (polarized.cpp:174-192: dN^{mn} = -(A^m_b N^{bn} + A^n_b N^{mb}))
    never requires the full (..., 4, 4, 4) Christoffel tensor: with the
    rank-1 Kerr-Schild structure g_{mn} = eta_{mn} + f l_m l_n every term
    of k^a Gamma^m_{ab} collapses to products of the scalars
    (f, l_i, df_i, dl_i/dx_j) from :func:`geometry.ks_derivatives_c`.
    Derivation: with D_db = k^a d_a g_db, C_db = k^a d_b g_da,
    E_db = k^a d_d g_ab and T_db = D + C - E, one has
    A^m_b = 1/2 g^{md} T_db = 1/2 (eta^{mm} T_mb - f l^m U_b) where
    U_b = -T_0b + l_i T_ib.

    Args:
      x1, x2, x3: (...,) CKS spatial coordinates.
      k0..k3: (...,) CONTRAVARIANT vector k^a to transport along.
      derivs: optional precomputed ks_derivatives_c output at (x1,x2,x3)
        to share between calls at the same position.

    Returns a 4x4 nested list of (...,) arrays A[m][b].
    """
    if flat:
        zero = jnp.zeros_like(k0)
        return [[zero] * 4 for _ in range(4)]
    if derivs is None:
        derivs = geometry.ks_derivatives_c(x1, x2, x3, spin, mass)
    _, f, (l1, l2, l3), (df1, df2, df3), (dl1, dl2, dl3) = derivs

    zero = jnp.zeros_like(k0)
    one = jnp.ones_like(k0)
    l_cov = (one, l1, l2, l3)            # covariant l_m (l_0 = 1)
    lk = k0 + l1 * k1 + l2 * k2 + l3 * k3          # l_a k^a
    kdf = k1 * df1 + k2 * df2 + k3 * df3           # k^a d_a f
    # kdl_d = k^a d_a l_d ; s_b = k^a d_b l_a ; both zero in the t slot
    kdl = (zero,
           k1 * dl1[0] + k2 * dl1[1] + k3 * dl1[2],
           k1 * dl2[0] + k2 * dl2[1] + k3 * dl2[2],
           k1 * dl3[0] + k2 * dl3[1] + k3 * dl3[2])
    s = (zero,
         dl1[0] * k1 + dl2[0] * k2 + dl3[0] * k3,
         dl1[1] * k1 + dl2[1] * k2 + dl3[1] * k3,
         dl1[2] * k1 + dl2[2] * k2 + dl3[2] * k3)
    df = (zero, df1, df2, df3)
    # P[b][d] = d_b l_d (b = direction, d = component); t row/col zero
    P = ((zero, zero, zero, zero),
         (zero, dl1[0], dl2[0], dl3[0]),
         (zero, dl1[1], dl2[1], dl3[1]),
         (zero, dl1[2], dl2[2], dl3[2]))

    T = [[kdf * l_cov[d] * l_cov[b]
          + f * (kdl[d] * l_cov[b] + l_cov[d] * kdl[b])
          + df[b] * l_cov[d] * lk + f * lk * P[b][d] + f * l_cov[d] * s[b]
          - df[d] * lk * l_cov[b] - f * s[d] * l_cov[b] - f * lk * P[d][b]
          for b in range(4)] for d in range(4)]
    U = [-T[0][b] + l1 * T[1][b] + l2 * T[2][b] + l3 * T[3][b]
         for b in range(4)]
    A = [[0.5 * (-T[0][b] + f * U[b]) for b in range(4)]]
    for i, li in ((1, l1), (2, l2), (3, l3)):
        A.append([0.5 * (T[i][b] - f * li * U[b]) for b in range(4)])
    return A
