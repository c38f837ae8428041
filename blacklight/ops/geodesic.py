"""Batched null-geodesic integration as a jax.lax.scan.

Batched re-design of the reference integrators (src/geodesic_integrator/
geodesics.cpp:39-925). The reference runs one adaptive loop per pixel under
OpenMP; here the whole pixel bundle advances in lock-step through a scan with
per-ray masks for termination, truncation, and failure:

- ``rk4`` / ``rk2``: exact semantic parity with the reference fixed-step
  integrators (geodesics.cpp:418-606, 626-795): step h = -ray_step*(r - r_horizon),
  midpoint storage, per-step null renormalization, the same termination and
  post-truncation rules.
- ``dp``: Dormand-Prince RK5(4)7M with the reference's error control
  (geodesics.cpp:39-323). Divergence from the reference, by design: instead
  of growing h without bound and *subdividing* each accepted step with
  4th-order dense output into proper-length-limited samples
  (geodesics.cpp:226-293) - a serial-CPU optimization - we cap h so each
  accepted step directly satisfies the same proper-length sample-density
  bound (delta_s <= ray_step * r). Sample positions then differ from the
  reference at the interpolation level while the quadrature density (and
  hence image accuracy) is the same.

Each scan iteration emits one (possibly invalid) sample: for rejected DP
attempts or dead rays the sample carries valid=False and len=0, so downstream
consumers are hole-tolerant by masking, never by compaction. Samples stream
in camera -> far-end order (the integration order); the radiative-transfer
scans consume them directly (see blacklight/transfer/).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from blacklight.constants import RayIntegrator
from blacklight.ops import geometry

# Dormand-Prince RK5(4)7M coefficients (1980 JCoAM 6 19), as in
# reference geodesics.cpp:42-72.
_DP_A = np.zeros((7, 6))
_DP_A[1, 0] = 1.0 / 5.0
_DP_A[2, :2] = [3.0 / 40.0, 9.0 / 40.0]
_DP_A[3, :3] = [44.0 / 45.0, -56.0 / 15.0, 32.0 / 9.0]
_DP_A[4, :4] = [19372.0 / 6561.0, -25360.0 / 2187.0, 64448.0 / 6561.0, -212.0 / 729.0]
_DP_A[5, :5] = [9017.0 / 3168.0, -355.0 / 33.0, 46732.0 / 5247.0, 49.0 / 176.0,
                -5103.0 / 18656.0]
_DP_A[6, :6] = [35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0, -2187.0 / 6784.0,
                11.0 / 84.0]
_DP_B5 = np.array([35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0,
                   -2187.0 / 6784.0, 11.0 / 84.0, 0.0])
_DP_B4 = np.array([5179.0 / 57600.0, 0.0, 7571.0 / 16695.0, 393.0 / 640.0,
                   -92097.0 / 339200.0, 187.0 / 2100.0, 1.0 / 40.0])
_DP_B4M = np.array([6025192743.0 / 30085553152.0, 0.0, 51252292925.0 / 65400821598.0,
                    -2691868925.0 / 45128329728.0, 187940372067.0 / 1594534317056.0,
                    -1776094331.0 / 19743644256.0, 11237099.0 / 235043384.0])
_DP_ERR_POWER = 0.2
_DP_ERR_FACTOR = 0.9
_DP_MIN_FACTOR = 0.2
_DP_MAX_FACTOR = 10.0


@dataclasses.dataclass(frozen=True)
class GeodesicParams:
    """Static integration parameters (subset of Config, all Python scalars)."""

    integrator: RayIntegrator
    bh_m: float
    bh_a: float
    ray_flat: bool
    ray_step: float
    ray_max_steps: int
    r_terminate: float
    camera_r: float
    r_horizon: float
    ray_tol_abs: float = 1.0e-8
    ray_tol_rel: float = 1.0e-8
    ray_max_retries: int = 20
    with_distance: bool = False


def horizon_radius(bh_m: float, bh_a: float) -> float:
    """r_+ = M + sqrt(M^2 - a^2) (reference geodesic_integrator.cpp:117)."""
    return bh_m + float(np.sqrt(bh_m * bh_m - bh_a * bh_a))


def terminate_radius(ray_terminate, ray_factor: float, bh_m: float, bh_a: float) -> float:
    """Inner termination radius (reference geodesic_integrator.cpp:118-123)."""
    from blacklight.constants import RayTerminate
    r_h = horizon_radius(bh_m, bh_a)
    if ray_terminate == RayTerminate.photon:
        return 2.0 * bh_m * (1.0 + np.cos(2.0 / 3.0 * np.arccos(-abs(bh_a) / bh_m)))
    if ray_terminate == RayTerminate.multiplicative:
        return r_h * ray_factor
    return r_h + ray_factor  # additive


def geodesic_rhs(y, spin, mass=1.0, flat=False, with_distance=False):
    """Right-hand side of the geodesic ODE (reference geodesics.cpp:867-925).

      dx^mu/dlambda = g^{munu} p_nu
      dp_i /dlambda = -1/2 d_i g^{munu} p_mu p_nu      (p_0 conserved)
      ds   /dlambda = -sqrt(g_{ij} q^i q^j),  q^i = (g^{imu} - g^{0i}g^{0mu}/g^{00}) p_mu

    Args:
      y: (..., 8) state [x^0..x^3, p_0..p_3] (covariant momentum).

    Returns:
      (..., 8) or (..., 9) derivative (distance appended when requested).
    """
    return geometry.geodesic_rhs_scalar(y, spin, mass, flat=flat,
                                        with_distance=with_distance)


class Sample(NamedTuple):
    """One emitted sample per scan iteration, batched over rays."""

    pos: jnp.ndarray     # (B, 4)
    dir: jnp.ndarray     # (B, 4) covariant momentum, null-renormalized
    len: jnp.ndarray     # (B,) affine step (negative: backward integration)
    valid: jnp.ndarray   # (B,) bool


class Carry(NamedTuple):
    y: jnp.ndarray            # (B, 8) current state
    alive: jnp.ndarray        # (B,) still integrating
    trunc: jnp.ndarray        # (B,) stored-sample truncation triggered
    flag: jnp.ndarray         # (B,) bad geodesic (step/retry limit)
    r_mid_prev: jnp.ndarray   # (B,) radius of previous stored sample
    n_samples: jnp.ndarray    # (B,) int32 count of valid samples
    h: jnp.ndarray            # (B,) next step size (dp), unused for rk
    num_retry: jnp.ndarray    # (B,) int32 dp retry counter
    prev_fail: jnp.ndarray    # (B,) bool dp previous attempt failed


def _renorm(x_pos, p_cov, params: GeodesicParams):
    return geometry.renormalize_null_momentum_scalar(
        x_pos, p_cov, params.bh_a, params.bh_m, flat=params.ray_flat)


def _park_state(y):
    """Benign state dead rays are parked at: far from the hole with a
    radial null-ish momentum. All metric/renormalization algebra is
    well-conditioned there, so no non-finite primal (whose adjoint would
    NaN-poison the backward scan) is ever produced for dead rays."""
    park = jnp.array([0.0, 1.0e3, 0.0, 0.0, -1.0, 1.0, 0.0, 0.0], y.dtype)
    return jnp.broadcast_to(park, y.shape)


def _rk_step(y, h, params: GeodesicParams):
    """One RK4 or RK2 step; returns (y_mid_raw, y_end_prenorm)."""
    rhs = lambda s: geodesic_rhs(s, params.bh_a, params.bh_m, flat=params.ray_flat)
    hb = h[..., None]
    if params.integrator == RayIntegrator.rk4:
        k1 = rhs(y)
        k2 = rhs(y + 0.5 * hb * k1)
        k3 = rhs(y + 0.5 * hb * k2)
        k4 = rhs(y + hb * k3)
        y_end = y + hb * (k1 / 6.0 + k2 / 3.0 + k3 / 3.0 + k4 / 6.0)
        y_mid = 0.5 * (y + y_end)
        return y_mid, y_end
    else:  # rk2 (Heun); reference stores y + h/2 k1 as the sample
        k1 = rhs(y)
        y_mid = y + 0.5 * hb * k1
        k2 = rhs(y + hb * k1)
        y_end = y + 0.5 * hb * (k1 + k2)
        return y_mid, y_end


def _make_rk_body(params: GeodesicParams):
    """Scan body for the fixed-step integrators (rk4/rk2)."""

    def body(carry: Carry, n):
        y = carry.y
        r = geometry.radius(y[..., 1:4], params.bh_a)
        # Dead rays take zero-length steps: their held state may sit near
        # the horizon where further RK substeps produce non-finite values
        # whose adjoints would NaN-poison the backward scan even though
        # the forward pass masks them out (NaN-through-select).
        h = jnp.where(carry.alive,
                      -params.ray_step * (r - params.r_horizon), 0.0)

        y_mid, y_end = _rk_step(y, h, params)
        p_end = _renorm(y_end[..., 1:4], y_end[..., 4:8], params)
        y_new = jnp.concatenate([y_end[..., 0:4], p_end], axis=-1)
        r_new = geometry.radius(y_new[..., 1:4], params.bh_a)

        # Stored sample: midpoint with renormalized momentum (the reference
        # renormalizes stored momenta in a post-pass, geodesics.cpp:561-581).
        mid_pos = y_mid[..., 0:4]
        mid_dir = _renorm(mid_pos[..., 1:4], y_mid[..., 4:8], params)
        r_mid = geometry.radius(mid_pos[..., 1:4], params.bh_a)

        # Truncation of stored samples (post-pass, geodesics.cpp:536-559):
        # applies from the second stored sample onward.
        have_prev = carry.n_samples > 0
        trunc_now = have_prev & (
            ((r_mid > params.camera_r) & (r_mid > carry.r_mid_prev))
            | (r_mid < params.r_terminate))
        trunc = carry.trunc | trunc_now
        valid = carry.alive & ~trunc

        # Step termination (geodesics.cpp:523-532)
        terminate = ((r_new > params.camera_r) & (r_new > r)) | (r_new < params.r_terminate)
        is_last = n == params.ray_max_steps - 1
        flag = carry.flag | (carry.alive & ~terminate & is_last)
        alive = carry.alive & ~terminate

        # Dead rays park at a benign state: their terminal state (possibly
        # inside the horizon) is never needed again, and stepping from it
        # would create non-finite primals that poison gradients.
        y_next = jnp.where(alive[..., None], y_new, _park_state(y))
        sample = Sample(pos=mid_pos, dir=mid_dir,
                        len=jnp.where(valid, h, 0.0), valid=valid)
        new_carry = Carry(
            y=y_next, alive=alive, trunc=trunc, flag=flag,
            r_mid_prev=jnp.where(valid, r_mid, carry.r_mid_prev),
            n_samples=carry.n_samples + valid.astype(jnp.int32),
            h=carry.h, num_retry=carry.num_retry, prev_fail=carry.prev_fail)
        return new_carry, sample

    return body


def _make_dp_body(params: GeodesicParams):
    """Scan body for Dormand-Prince: one attempted step per iteration."""
    def rhs(s):
        return geodesic_rhs(s, params.bh_a, params.bh_m, flat=params.ray_flat,
                            with_distance=True)

    def body(carry: Carry, n):
        y9 = jnp.concatenate([carry.y, jnp.zeros_like(carry.y[..., :1])], axis=-1)
        r = geometry.radius(carry.y[..., 1:4], params.bh_a)

        # Evaluate the 7 substeps
        k0 = rhs(y9)
        # Cap |h| so one accepted step obeys the reference's sample-density
        # bound delta_s <= ray_step * r (replaces dense-output subdivision).
        # Floor at 1e-10, not epsilon: 1/x's VJP carries 1/x^2, which
        # overflows float32 (-> 0 * inf = NaN in reverse-mode) for
        # x < ~1e-19 even under a zero cotangent; near-stationary lanes
        # produce a huge h_cap either way and the min() below ignores it.
        ds_dlam = jnp.maximum(jnp.abs(k0[..., 8]), 1e-10)
        h_cap = params.ray_step * r / ds_dlam
        h = -jnp.minimum(jnp.abs(carry.h), h_cap)

        hb = h[..., None]
        ks = [k0]
        for i in range(1, 7):
            y_sub = y9
            for q in range(i):
                if _DP_A[i][q] != 0.0:
                    # float(): numpy f64 scalars are strong-typed and would
                    # promote float32 states under x64
                    y_sub = y_sub + (float(_DP_A[i][q]) * hb) * ks[q]
            ks.append(rhs(y_sub))

        # Unrolled weighted sums: a (B, 7, 9) stack + einsum would put the
        # tiny substep/component axes on the lanes; plain fused adds keep
        # everything (B, 9)-elementwise.
        def combine(weights):
            acc = None
            for q in range(7):
                if weights[q] == 0.0:
                    continue
                term = float(weights[q]) * ks[q]
                acc = term if acc is None else acc + term
            return y9 + hb * acc

        y5 = combine(_DP_B5)
        y4 = combine(_DP_B4)
        y4m = combine(_DP_B4M)

        # Error estimate over the 8 dynamical components (geodesics.cpp:186-194)
        y_abs = jnp.maximum(jnp.abs(y9[..., :8]), jnp.abs(y5[..., :8]))
        scale = params.ray_tol_abs + params.ray_tol_rel * y_abs
        err = jnp.max(jnp.abs(y5[..., :8] - y4[..., :8]) / scale, axis=-1)

        accept = err <= 1.0
        # Step-size update (geodesics.cpp:197-224). AD-safe pow input:
        # x**(-0.2)'s VJP carries x**(-1.2), which overflows float32
        # (-> inf -> 0 * inf = NaN in reverse-mode) for err < ~1e-32 even
        # under a zero cotangent - and parked/exact lanes do reach such
        # err. Lanes with err <= 1e-10 clip to _DP_MAX_FACTOR anyway
        # (0.9 * (1e-10)^-0.2 = 90 > 10), so routing them around the pow
        # is forward-exact.
        tiny_err = err <= 1e-10
        err_safe = jnp.where(tiny_err, 1.0, jnp.maximum(err, 1e-300))
        fac_ideal = jnp.where(
            tiny_err, _DP_MAX_FACTOR,
            _DP_ERR_FACTOR * err_safe ** (-_DP_ERR_POWER))
        fac_rej = jnp.maximum(jnp.where(jnp.isfinite(err), fac_ideal, _DP_MIN_FACTOR),
                              _DP_MIN_FACTOR)
        fac_acc = jnp.clip(fac_ideal, _DP_MIN_FACTOR, _DP_MAX_FACTOR)
        fac_acc = jnp.where(err == 0.0, _DP_MAX_FACTOR, fac_acc)
        fac_acc = jnp.where(carry.prev_fail, jnp.minimum(fac_acc, 1.0), fac_acc)
        h_next = h * jnp.where(accept, fac_acc, fac_rej)

        num_retry = jnp.where(accept, 0, carry.num_retry + 1)
        retry_exceeded = num_retry > params.ray_max_retries
        flag = carry.flag | (carry.alive & retry_exceeded)
        dead_from_retry = carry.alive & retry_exceeded

        # Accepted step: renormalize momentum at the endpoint
        p_end = _renorm(y5[..., 1:4], y5[..., 4:8], params)
        y_new = jnp.concatenate([y5[..., 0:4], p_end], axis=-1)
        r_new = geometry.radius(y_new[..., 1:4], params.bh_a)

        # Stored sample = 4th-order midpoint (geodesics.cpp:247-259)
        mid_pos = y4m[..., 0:4]
        mid_dir = _renorm(mid_pos[..., 1:4], y4m[..., 4:8], params)
        r_mid = geometry.radius(mid_pos[..., 1:4], params.bh_a)

        have_prev = carry.n_samples > 0
        trunc_now = have_prev & (
            ((r_mid > params.camera_r) & (r_mid > carry.r_mid_prev))
            | (r_mid < params.r_terminate))
        trunc = carry.trunc | jnp.where(accept, trunc_now, False)
        valid = carry.alive & accept & ~trunc & ~retry_exceeded

        terminate = ((r_new > params.camera_r) & (r_new > r)) | (r_new < params.r_terminate)
        is_last = n == params.ray_max_steps - 1
        flag = flag | (carry.alive & accept & ~terminate & is_last)
        alive = carry.alive & ~(accept & terminate) & ~dead_from_retry

        step_taken = carry.alive & accept
        y_next = jnp.where(alive[..., None],
                           jnp.where(step_taken[..., None], y_new, carry.y),
                           _park_state(carry.y))
        sample = Sample(pos=mid_pos, dir=mid_dir,
                        len=jnp.where(valid, h, 0.0), valid=valid)
        new_carry = Carry(
            y=y_next, alive=alive, trunc=trunc, flag=flag,
            r_mid_prev=jnp.where(valid, r_mid, carry.r_mid_prev),
            n_samples=carry.n_samples + valid.astype(jnp.int32),
            h=jnp.where(carry.alive, h_next, carry.h),
            num_retry=jnp.where(carry.alive, num_retry, carry.num_retry),
            prev_fail=jnp.where(carry.alive, ~accept, carry.prev_fail))
        return new_carry, sample

    return body


def initial_carry(positions, directions, params: GeodesicParams) -> Carry:
    """Build the scan carry from camera rays (positions (B,4), directions (B,4))."""
    y0 = jnp.concatenate([positions, directions], axis=-1)
    b = positions.shape[0]
    r0 = geometry.radius(positions[..., 1:4], params.bh_a)
    return Carry(
        y=y0,
        alive=jnp.ones(b, dtype=bool),
        trunc=jnp.zeros(b, dtype=bool),
        flag=jnp.zeros(b, dtype=bool),
        r_mid_prev=jnp.zeros(b, dtype=positions.dtype),
        n_samples=jnp.zeros(b, dtype=jnp.int32),
        h=-params.ray_step * r0,  # dp initial step (geodesics.cpp:131)
        num_retry=jnp.zeros(b, dtype=jnp.int32),
        prev_fail=jnp.zeros(b, dtype=bool),
    )


def make_scan_body(params: GeodesicParams) -> Callable:
    if params.integrator == RayIntegrator.dp:
        return _make_dp_body(params)
    return _make_rk_body(params)


def trace_geodesics(positions, directions, params: GeodesicParams):
    """Materialize the full sampled geodesics (for polarized RT / checkpoints).

    Returns:
      samples: Sample with arrays of shape (S, B, ...) in scan (step-major)
        order, camera-first along the ray.
      flags: (B,) bad-geodesic flags.
      n_samples: (B,) number of valid samples per ray.
    """
    body = make_scan_body(params)
    carry0 = initial_carry(positions, directions, params)
    carry, samples = jax.lax.scan(body, carry0, jnp.arange(params.ray_max_steps))
    return samples, carry.flag, carry.n_samples


def compact_samples(samples: Sample):
    """Pack valid samples to the front of the step axis, preserving order.

    The dp integrator leaves holes (rejected attempts emit valid=False); the
    polarized reverse scan needs consecutive samples with access to the
    next sample's step size. A stable argsort on ~valid compacts in
    O(S log S) per ray.

    Args:
      samples: Sample with (S, B, ...) arrays.

    Returns:
      Compacted Sample (same shapes; invalid entries pushed to the end).
    """
    order = jnp.argsort(~samples.valid, axis=0, stable=True)  # (S, B)
    def take(arr):
        if arr.ndim == 3:
            return jnp.take_along_axis(arr, order[..., None], axis=0)
        return jnp.take_along_axis(arr, order, axis=0)
    return Sample(pos=take(samples.pos), dir=take(samples.dir),
                  len=take(samples.len), valid=take(samples.valid))


def streaming_reduce(positions, directions, params: GeodesicParams,
                     contribution_fn: Callable, init_state,
                     early_exit: bool = False):
    """Fused geodesic integration + per-sample reduction (no materialization).

    Runs the geodesic scan and feeds every emitted sample to
    ``contribution_fn(state, sample) -> state``, where sample is a
    :class:`Sample` batch. This is the memory-optimal path for unpolarized
    radiative transfer: nothing of the geodesic path is ever stored.

    With ``early_exit`` the step loop is a lax.while_loop that stops once
    every ray in the bundle has terminated - typically a large win because
    ray lengths are ragged (the reference pads to max over pixels,
    geodesics.cpp:374-377). The while form is forward-only (not
    reverse-differentiable); use the default scan for gradients.

    Returns (final_state, flags, n_samples).
    """
    step_body = make_scan_body(params)
    carry0 = initial_carry(positions, directions, params)

    if early_exit:
        def cond(loop_state):
            n, carry, _ = loop_state
            return (n < params.ray_max_steps) & jnp.any(carry.alive)

        def body(loop_state):
            n, carry, state = loop_state
            carry, sample = step_body(carry, n)
            state = contribution_fn(state, sample)
            return (n + 1, carry, state)

        _, carry, state = jax.lax.while_loop(
            cond, body, (jnp.asarray(0, jnp.int32), carry0, init_state))
        return state, carry.flag, carry.n_samples

    def body(carry_state, n):
        carry, state = carry_state
        carry, sample = step_body(carry, n)
        state = contribution_fn(state, sample)
        return (carry, state), None

    # Rematerialize per-step internals in the backward pass: without this,
    # reverse-mode stores every intermediate of every step (RK stages,
    # coefficients, ...) - O(steps * B * internals) memory; with it, only
    # the per-step carries are saved and the body recomputes (SURVEY hard
    # part 5: checkpointed scan instead of storing 7000 steps).
    (carry, state), _ = jax.lax.scan(jax.checkpoint(body),
                                     (carry0, init_state),
                                     jnp.arange(params.ray_max_steps))
    return state, carry.flag, carry.n_samples


def masked_step(params: GeodesicParams) -> Callable:
    """Scan body that freezes the carry and invalidates samples for step
    indices past ray_max_steps (so windowed drivers whose last window
    overruns the step budget match the plain scan exactly)."""
    body = make_scan_body(params)

    def step(carry, n):
        new_carry, sample = body(carry, n)
        live = n < params.ray_max_steps
        carry = jax.tree.map(lambda a, b: jnp.where(live, a, b),
                             new_carry, carry)
        sample = Sample(pos=sample.pos, dir=sample.dir,
                        len=jnp.where(live, sample.len, 0.0),
                        valid=sample.valid & live)
        return carry, sample

    return step


def segment_carries(positions, directions, params: GeodesicParams,
                    window: int):
    """Sweep the full geodesic integration, storing only each window's
    initial carry (sqrt-checkpointing for order-reversed consumers).

    The polarized transfer must process samples far-end -> camera but the
    geodesic integrates camera -> far-end; instead of materializing all
    (S, B) samples, store the integrator carry at K = ceil(S/window)
    window boundaries and re-integrate one window at a time in reverse
    segment order (replay_window), bit-identically.

    Returns (starts, flags, n_samples): starts is a Carry pytree with
    (K, B, ...) leaves (starts[k] = carry entering step k*window).
    """
    step = masked_step(params)
    carry0 = initial_carry(positions, directions, params)
    n_seg = -(-params.ray_max_steps // window)

    def seg(carry, k):
        start = carry

        def inner(c, n):
            c, _ = step(c, n)
            return c, None

        ns = k * window + jnp.arange(window)
        carry, _ = jax.lax.scan(inner, carry, ns)
        return carry, start

    carry, starts = jax.lax.scan(seg, carry0, jnp.arange(n_seg))
    return starts, carry.flag, carry.n_samples


def replay_window(start_carry, params: GeodesicParams, k, window: int):
    """Re-integrate one window from its boundary carry (segment_carries),
    materializing that window's (window, B) samples only. k may be traced
    (reverse segment scans)."""
    step = masked_step(params)
    ns = k * window + jnp.arange(window)
    _, samples = jax.lax.scan(step, start_carry, ns)
    return samples


def windowed_reduce(positions, directions, params: GeodesicParams,
                    prep_fn: Callable, contribution_fn: Callable, init_state,
                    window: int):
    """Windowed fused reduction: integrate W geodesic steps, run a batch
    prep over the window's samples, then reduce the window step by step.

    The wavefront sampler's loop structure (docs/performance.md): rays in
    a coherent bundle touch a small, slowly-moving set of grid cells, so a
    window of W steps can be sampled with ONE deduplicated gather instead
    of W per-step gathers. This helper owns only the loop skeleton; the
    sampling lives in prep_fn/contribution_fn:

      prep_fn(samples) -> (aux_steps, aux_const, window_flag)
        samples: Sample pytree with (W, B, ...) leaves for one window.
        aux_steps: pytree with leading axis W, sliced per step.
        aux_const: pytree passed whole to every step.
        window_flag: () bool, OR-accumulated across windows (e.g. table
          overflow).
      contribution_fn(state, sample, aux_step, aux_const) -> state

    The outer loop is a lax.while_loop over ceil(max_steps / W) windows
    with early exit once every ray has terminated; like streaming_reduce's
    early_exit form it is forward-only (gradients use the plain scan
    path). Steps past ray_max_steps in the final window are masked and the
    carry is frozen there, so flags/n_samples match the unwindowed scan
    exactly.

    Returns (final_state, flags, n_samples, prep_flag).
    """
    carry0 = initial_carry(positions, directions, params)
    n_windows = -(-params.ray_max_steps // window)
    body_a = masked_step(params)

    def outer(loop_state):
        w_idx, carry, state, pflag = loop_state
        ns = w_idx * window + jnp.arange(window)
        carry, samples = jax.lax.scan(body_a, carry, ns)
        aux_steps, aux_const, window_flag = prep_fn(samples)

        def body_b(st, xs):
            sample, aux = xs
            return contribution_fn(st, sample, aux, aux_const), None

        state, _ = jax.lax.scan(body_b, state, (samples, aux_steps))
        return (w_idx + 1, carry, state, pflag | window_flag)

    def cond(loop_state):
        w_idx, carry, _, _ = loop_state
        return (w_idx < n_windows) & jnp.any(carry.alive)

    _, carry, state, pflag = jax.lax.while_loop(
        cond, outer,
        (jnp.asarray(0, jnp.int32), carry0, init_state,
         jnp.asarray(False)))
    return state, carry.flag, carry.n_samples, pflag
