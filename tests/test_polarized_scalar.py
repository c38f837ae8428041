"""Component (scalarized) polarized-coupling and transport forms must match
the stacked reference implementations exactly (same formulas, reordered)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blacklight.ops import connection as connection_mod
from blacklight.transfer import polarized_coupling as pc


def _random_coeffs(rng, n, regime):
    """Coefficient draws hitting each coupling regime
    (polarized.cpp:380-790 ladder)."""
    j_i = rng.uniform(0.0, 1.0, n)
    j_q = rng.uniform(-0.3, 0.3, n)
    j_v = rng.uniform(-0.3, 0.3, n)
    a_i = rng.uniform(0.1, 2.0, n)
    a1 = rng.uniform(-0.5, 0.5, n)
    a3 = rng.uniform(-0.5, 0.5, n)
    rho1 = rng.uniform(-1.0, 1.0, n)
    rho3 = rng.uniform(-1.0, 1.0, n)
    if regime == "free":
        a_i = np.zeros(n)
        a1 = a3 = np.zeros(n)
        rho1 = rho3 = np.zeros(n)
    elif regime == "simple":
        a1 = a3 = np.zeros(n)
        rho1 = rho3 = np.zeros(n)
    elif regime == "rotate":
        a_i = np.zeros(n)
        a1 = a3 = np.zeros(n)
    elif regime == "absorb":
        rho1 = rho3 = np.zeros(n)
    elif regime == "thick":
        a_i = rng.uniform(150.0, 300.0, n)
    return dict(j_i=j_i, j_q=j_q, j_v=j_v, alpha_i=a_i, alpha_q=a1,
                alpha_v=a3, rho_q=rho1, rho_v=rho3)


@pytest.mark.parametrize("regime",
                         ["free", "simple", "rotate", "absorb", "full",
                          "thick"])
@pytest.mark.parametrize("rotation_split", [False, True])
def test_couple_matter_component_matches_stacked(regime, rotation_split):
    rng = np.random.default_rng(42)
    n = 256
    coeffs = {k: jnp.asarray(v) for k, v in _random_coeffs(rng, n,
                                                           regime).items()}
    ss = jnp.asarray(rng.normal(size=(n, 4)))
    # I >= 0 keeps the admissibility clamp in its generic branch
    ss = ss.at[:, 0].set(jnp.abs(ss[:, 0]) + 0.1)
    dl = jnp.asarray(rng.uniform(0.01, 1.0, n))

    ref = pc.couple_matter(ss, coeffs, dl, rotation_split)
    out = pc.couple_matter_c(
        ss[:, 0], ss[:, 1], ss[:, 2], ss[:, 3],
        coeffs["j_i"], coeffs["j_q"], coeffs["j_v"],
        coeffs["alpha_i"], coeffs["alpha_q"], coeffs["alpha_v"],
        coeffs["rho_q"], coeffs["rho_v"], dl, rotation_split)
    got = jnp.stack(out, axis=-1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-12, atol=1e-13)


def test_transport_matrix_c_matches_connection():
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.uniform(-12, 12, (128, 3)))
    k = jnp.asarray(rng.normal(size=(128, 4)))
    spin = 0.9375
    conn = connection_mod.connection_cks(x, spin)
    a_ref = jnp.einsum("Ba,Bmab->Bmb", k, conn)
    a_c = connection_mod.transport_matrix_c(
        x[:, 0], x[:, 1], x[:, 2], k[:, 0], k[:, 1], k[:, 2], k[:, 3], spin)
    a_new = jnp.stack([jnp.stack(row, -1) for row in a_c], -2)
    np.testing.assert_allclose(np.asarray(a_new), np.asarray(a_ref),
                               rtol=1e-10, atol=1e-13)


def test_transport_matrix_c_flat():
    zero3 = jnp.zeros(5)
    a_c = connection_mod.transport_matrix_c(
        zero3, zero3, zero3, zero3 + 1.0, zero3, zero3, zero3, 0.9,
        flat=True)
    for row in a_c:
        for el in row:
            assert not np.any(np.asarray(el))
