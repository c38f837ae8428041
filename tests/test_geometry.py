"""Unit tests for CKS Kerr-Schild geometry against closed-form GR identities."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blacklight.ops import geometry

SPINS = [0.0, 0.5, 0.9, -0.7]


def sample_points(seed=0, n=64):
    rng = np.random.default_rng(seed)
    # Avoid the ring singularity / horizon: radii in [3, 50]
    r = rng.uniform(3.0, 50.0, n)
    th = rng.uniform(0.1, np.pi - 0.1, n)
    ph = rng.uniform(0.0, 2 * np.pi, n)
    x = r * np.sin(th) * np.cos(ph)
    y = r * np.sin(th) * np.sin(ph)
    z = r * np.cos(th)
    return jnp.array(np.stack([x, y, z], axis=-1))


@pytest.mark.parametrize("spin", SPINS)
def test_radius_satisfies_quartic(spin):
    x = sample_points()
    r = geometry.radius(x, spin)
    rr2 = jnp.sum(x * x, axis=-1)
    z = x[..., 2]
    resid = r**4 - r**2 * (rr2 - spin**2) - spin**2 * z**2
    np.testing.assert_allclose(resid / r**4, 0.0, atol=1e-12)


@pytest.mark.parametrize("spin", SPINS)
def test_metric_inverse(spin):
    x = sample_points()
    g_cov = geometry.gcov(x, spin)
    g_con = geometry.gcon(x, spin)
    prod = jnp.einsum("...ij,...jk->...ik", g_cov, g_con)
    eye = jnp.broadcast_to(jnp.eye(4), prod.shape)
    np.testing.assert_allclose(prod, eye, atol=1e-12)


@pytest.mark.parametrize("spin", SPINS)
def test_metric_symmetry(spin):
    x = sample_points()
    g_cov = geometry.gcov(x, spin)
    np.testing.assert_allclose(g_cov, jnp.swapaxes(g_cov, -1, -2), atol=0)


def test_flat_metric():
    x = sample_points()
    g = geometry.gcov(x, 0.9, flat=True)
    eta = np.diag([-1.0, 1.0, 1.0, 1.0])
    np.testing.assert_allclose(g, np.broadcast_to(eta, g.shape), atol=0)
    d = geometry.dgcon(x, 0.9, flat=True)
    np.testing.assert_allclose(d, 0.0, atol=0)


def test_schwarzschild_limit():
    """a=0: g_tt = -(1 - 2M/r) + KS cross terms; check known invariant g^00."""
    x = sample_points()
    r = geometry.radius(x, 0.0)
    g_con = geometry.gcon(x, 0.0)
    np.testing.assert_allclose(g_con[..., 0, 0], -(1.0 + 2.0 / r), rtol=1e-12)


@pytest.mark.parametrize("spin", SPINS)
def test_dgcon_matches_autodiff(spin):
    """Analytic derivative of g^{munu} must agree with jax.jacfwd."""
    x = sample_points(n=8)
    analytic = geometry.dgcon(x, spin)

    def gcon_single(pt):
        return geometry.gcon(pt, spin)

    # jacfwd gives (..., 4, 4, 3); transpose to (..., 3, 4, 4)
    jac = jax.vmap(jax.jacfwd(gcon_single))(x)
    autodiff = jnp.moveaxis(jac, -1, -3)
    np.testing.assert_allclose(analytic, autodiff, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("spin", SPINS)
def test_null_renormalization(spin):
    """Renormalized momenta satisfy the null condition exactly."""
    x = sample_points()
    g_cov = geometry.gcov(x, spin)
    g_con = geometry.gcon(x, spin)
    rng = np.random.default_rng(1)
    # Start from a slightly perturbed null momentum
    p_spatial_con = jnp.array(rng.normal(size=(x.shape[0], 3)))
    p0_con = geometry.null_momentum_time_component(g_cov, p_spatial_con)
    p_con = jnp.concatenate([p0_con[:, None], p_spatial_con], axis=-1)
    p_cov = jnp.einsum("...ij,...j->...i", g_cov, p_con)
    # Verify the solve itself produced a null vector
    norm = jnp.einsum("...ij,...i,...j->...", g_con, p_cov, p_cov)
    np.testing.assert_allclose(norm, 0.0, atol=1e-10)
    # Perturb spatial covariant momentum, renormalize, re-check
    p_cov_pert = p_cov.at[:, 1:].multiply(1.0 + 0.01)
    p_fixed = geometry.renormalize_null_momentum(g_con, p_cov_pert)
    norm2 = jnp.einsum("...ij,...i,...j->...", g_con, p_fixed, p_fixed)
    np.testing.assert_allclose(norm2, 0.0, atol=1e-10)
    # p_0 unchanged
    np.testing.assert_allclose(p_fixed[:, 0], p_cov_pert[:, 0], atol=0)


def test_renormalization_zero_denominator_keeps_momentum():
    """Backward-traced momenta diverge at the horizon, where float32 can
    cancel the renormalization quadratic's denominator to exactly 0: the
    step then keeps its momentum (factor 1) instead of an infinite one,
    with a finite gradient. On the axis at r = 2 of a non-spinning hole
    f = 1, so with p along l, a = |p|^2 - f (l.p)^2 = 0 and b < 0 selects
    the (d - b) / 2a root."""
    f32 = jnp.float32

    def factor(p0):
        return geometry.renormalize_factor_c(
            f32(0.0), f32(0.0), f32(2.0), p0, f32(0.0), f32(0.0), f32(1.0),
            0.0)

    assert float(factor(f32(-1.0))) == 1.0
    assert np.isfinite(float(jax.grad(factor)(f32(-1.0))))


def test_horizon_radius():
    """r_horizon = M + sqrt(M^2 - a^2); f diverges only inside."""
    spin = 0.9
    r_h = 1.0 + np.sqrt(1.0 - spin**2)
    # Points exactly at the horizon radius in the equatorial plane
    x = jnp.array([[r_h * np.cos(0.3) + 0.0, r_h * np.sin(0.3), 0.0]])
    r = geometry.radius(x, spin)
    # In the equatorial plane, CKS radius solves r^2 = |x|^2 - a^2 ... check quartic instead
    resid = r**4 - r**2 * (jnp.sum(x * x) - spin**2)
    np.testing.assert_allclose(resid, 0.0, atol=1e-10)


def test_gradients_flow_through_spin():
    """Metric is differentiable with respect to spin (new capability)."""
    x = sample_points(n=4)

    def loss(a):
        return jnp.sum(geometry.gcov(x, a) ** 2)

    g = jax.grad(loss)(0.5)
    assert np.isfinite(g)
    # Finite-difference check
    eps = 1e-6
    fd = (loss(0.5 + eps) - loss(0.5 - eps)) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-5)
