"""Geodesic integrator tests: flat-space straight lines, null conservation,
photon-ring capture, integrator cross-checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blacklight.constants import RayIntegrator, RayTerminate
from blacklight.ops import geodesic, geometry


def make_params(integrator=RayIntegrator.rk4, spin=0.9, flat=False,
                ray_step=0.01, max_steps=2000, camera_r=100.0,
                terminate=RayTerminate.additive, factor=5e-4):
    return geodesic.GeodesicParams(
        integrator=integrator, bh_m=1.0, bh_a=spin, ray_flat=flat,
        ray_step=ray_step, ray_max_steps=max_steps,
        r_terminate=geodesic.terminate_radius(terminate, factor, 1.0, spin),
        camera_r=camera_r, r_horizon=geodesic.horizon_radius(1.0, spin))


def launch_rays(b_impact, spin, camera_r=100.0, dtype=jnp.float64, flat=False):
    """Rays from x = camera_r moving in -x with impact parameter b in z."""
    b_impact = jnp.asarray(b_impact, dtype=dtype)
    n = b_impact.shape[0]
    pos = jnp.stack([jnp.zeros(n, dtype), jnp.full((n,), camera_r, dtype),
                     jnp.zeros(n, dtype), b_impact], axis=-1)
    # Backward integration: photon physically moves in -x toward BH, so the
    # backward-traced momentum points in +x; covariant p with p_x = +1.
    p_spatial_con = jnp.stack([jnp.ones(n, dtype), jnp.zeros(n, dtype),
                               jnp.zeros(n, dtype)], axis=-1)
    g_cov = geometry.gcov(pos[:, 1:], spin, flat=flat)
    p0 = geometry.null_momentum_time_component(g_cov, p_spatial_con)
    p_con = jnp.concatenate([p0[:, None], p_spatial_con], axis=-1)
    p_cov = jnp.einsum("...ij,...j->...i", g_cov, p_con)
    return pos, p_cov


def test_flat_space_straight_lines():
    """In Minkowski space rays are straight: z stays constant along the path."""
    params = make_params(flat=True, spin=0.0, max_steps=3000)
    pos, p_cov = launch_rays([5.0, 20.0], 0.0, flat=True)
    samples, flags, n = geodesic.trace_geodesics(pos, p_cov, params)
    assert not np.any(np.asarray(flags))
    valid = np.asarray(samples.valid)
    z = np.asarray(samples.pos[..., 3])
    zsel0 = z[valid[:, 0], 0]
    zsel1 = z[valid[:, 1], 1]
    np.testing.assert_allclose(zsel0, 5.0, rtol=1e-8)
    np.testing.assert_allclose(zsel1, 20.0, rtol=1e-8)


@pytest.mark.parametrize("integrator", [RayIntegrator.rk4, RayIntegrator.rk2,
                                        RayIntegrator.dp])
def test_null_norm_preserved(integrator):
    """Sampled momenta satisfy the null condition after renormalization."""
    params = make_params(integrator=integrator, spin=0.9, max_steps=1500)
    pos, p_cov = launch_rays([3.0, 7.0, 15.0], 0.9)
    samples, flags, n = geodesic.trace_geodesics(pos, p_cov, params)
    valid = np.asarray(samples.valid)
    sp = np.asarray(samples.pos)[valid]
    sd = np.asarray(samples.dir)[valid]
    g_con = geometry.gcon(jnp.asarray(sp[:, 1:]), 0.9)
    norm = jnp.einsum("...ij,...i,...j->...", g_con, jnp.asarray(sd), jnp.asarray(sd))
    # Normalize by the magnitude of the spatial-spatial term: near the horizon
    # momenta are large and the quadratic cancels to machine precision only in
    # a relative sense.
    scale = jnp.abs(jnp.einsum("...ij,...i,...j->...", g_con[:, 1:, 1:],
                               jnp.asarray(sd[:, 1:]), jnp.asarray(sd[:, 1:]))) + 1.0
    np.testing.assert_allclose(np.asarray(norm / scale), 0.0, atol=1e-10)


def test_photon_ring_capture_schwarzschild():
    """a=0: critical impact parameter is 3*sqrt(3) M = 5.196. Inside -> captured
    (ray terminates at r_terminate); outside -> escapes past camera radius."""
    params = make_params(spin=0.0, max_steps=4000, ray_step=0.005)
    b_vals = [3.0, 4.5, 5.0, 5.4, 6.0, 10.0]
    pos, p_cov = launch_rays(b_vals, 0.0)
    samples, flags, n = geodesic.trace_geodesics(pos, p_cov, params)
    assert not np.any(np.asarray(flags)), "rays should terminate in budget"
    # Radius of last valid sample per ray
    valid = np.asarray(samples.valid)
    r_all = np.asarray(geometry.radius(samples.pos[..., 1:], 0.0))
    crit = 3.0 * np.sqrt(3.0)
    for i, b in enumerate(b_vals):
        r_i = r_all[valid[:, i], i]
        captured = r_i.min() < 2.2  # fell close to horizon (r_h = 2)
        assert captured == (b < crit), f"b={b}: captured={captured}"


def test_dp_matches_rk4_trajectory():
    """DP and RK4 integrate the same ODE: the captured/escaped set and final
    radii agree."""
    b_vals = [4.0, 6.0, 8.0]
    pos, p_cov = launch_rays(b_vals, 0.9)
    p_rk4 = make_params(integrator=RayIntegrator.rk4, spin=0.9, max_steps=3000)
    p_dp = make_params(integrator=RayIntegrator.dp, spin=0.9, max_steps=3000)
    s4, f4, n4 = geodesic.trace_geodesics(pos, p_cov, p_rk4)
    sd, fd, nd = geodesic.trace_geodesics(pos, p_cov, p_dp)
    for i in range(len(b_vals)):
        v4 = np.asarray(s4.valid[:, i])
        vd = np.asarray(sd.valid[:, i])
        r4 = np.asarray(geometry.radius(s4.pos[..., 1:], 0.9))[v4, i]
        rd = np.asarray(geometry.radius(sd.pos[..., 1:], 0.9))[vd, i]
        assert (r4.min() < 2.0) == (rd.min() < 2.0)


def test_conserved_energy():
    """p_0 is exactly conserved (d p_0/dlambda = 0 and renorm keeps p_0)."""
    params = make_params(spin=0.9, max_steps=1000)
    pos, p_cov = launch_rays([5.0], 0.9)
    samples, _, _ = geodesic.trace_geodesics(pos, p_cov, params)
    valid = np.asarray(samples.valid[:, 0])
    p0 = np.asarray(samples.dir[:, 0, 0])[valid]
    np.testing.assert_allclose(p0, float(p_cov[0, 0]), rtol=1e-12)


def test_streaming_matches_materialized():
    """streaming_reduce must see exactly the same samples as trace_geodesics."""
    params = make_params(spin=0.9, max_steps=800)
    pos, p_cov = launch_rays([4.0, 9.0], 0.9)
    samples, flags, n = geodesic.trace_geodesics(pos, p_cov, params)

    def contribution(state, s):
        total, count = state
        w = s.valid.astype(s.pos.dtype)
        return (total + w * s.pos[:, 1], count + s.valid.astype(jnp.int32))

    init = (jnp.zeros(2), jnp.zeros(2, dtype=jnp.int32))
    (total, count), flags2, n2 = geodesic.streaming_reduce(
        pos, p_cov, params, contribution, init)
    v = np.asarray(samples.valid)
    expect = np.where(v, np.asarray(samples.pos[..., 1]), 0.0).sum(axis=0)
    np.testing.assert_allclose(np.asarray(total), expect, rtol=1e-14)
    np.testing.assert_array_equal(np.asarray(count), v.sum(axis=0))
    np.testing.assert_array_equal(np.asarray(n2), np.asarray(n))
    np.testing.assert_array_equal(np.asarray(flags2), np.asarray(flags))


def test_gradient_through_geodesic():
    """Final sampled position is differentiable wrt the impact parameter."""
    params = make_params(spin=0.5, max_steps=300, camera_r=30.0)

    def final_x(b):
        pos, p_cov = launch_rays(jnp.array([b]), 0.5, camera_r=30.0)
        samples, _, _ = geodesic.trace_geodesics(pos, p_cov, params)
        w = samples.valid.astype(samples.pos.dtype)
        return jnp.sum(samples.pos[:, 0, 3] * w[:, 0]) / jnp.sum(w[:, 0])

    g = jax.grad(final_x)(8.0)
    eps = 1e-5
    fd = (final_x(8.0 + eps) - final_x(8.0 - eps)) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-4)
