"""Unpolarized radiative transfer, fused with geodesic integration.

Re-derivation of the reference integrator (src/radiation_integrator/
unpolarized.cpp:31-221) as a *single streaming scan*: the reference first
materializes the full geodesic path and per-sample coefficient arrays
(N_freq x N_pix x N_step doubles - its largest memory cost,
simulation_coefficients.cpp:199-225), then runs the exponential-attenuation
recurrence from the far end of each ray toward the camera:

    I <- e^{-dtau} (I + S (e^{dtau} - 1))        [far -> near]

That recurrence re-orders exactly into a camera -> far accumulation

    I = sum_k S_k (1 - e^{-dtau_k}) e^{-tau_<k}

where tau_<k is the optical depth accumulated between the camera and sample
k over samples with alpha > 0. Because geodesics are integrated *from* the
camera, every sample can be consumed the moment it is produced: geodesic
step, coefficients, and RT all happen in one lax.scan iteration and nothing
is ever stored per step. The optically-thick saturation trap
(delta_tau > 100 -> I = S, unpolarized.cpp:96-110) maps to "contribute
S e^{-tau_<k}, then set tau = inf so everything farther is discarded".

All auxiliary image quantities (time/length/lambda/emission/tau/averages/
crossings, unpolarized.cpp:112-196) accumulate in the same pass.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from blacklight.constants import HIGHEST, NUM_CELL_VALUES, Physics
from blacklight.ops import geodesic, geometry

DELTA_TAU_MAX = 100.0  # reference radiation_integrator.hpp:191


@dataclasses.dataclass(frozen=True)
class ImageOptions:
    """Which image quantities to produce (reference image_* flags)."""

    light: bool = True
    time: bool = False
    length: bool = False
    lam: bool = False
    emission: bool = False
    tau: bool = False
    lambda_ave: bool = False
    emission_ave: bool = False
    tau_int: bool = False
    crossings: bool = False
    fallback_nan: bool = True
    # Slow light: track per-pixel min/max sample coordinate times so the
    # pipeline can reproduce the reference's extrapolation errors/warnings
    # (simulation_sampling.cpp:578-616)
    track_sample_times: bool = False

    @staticmethod
    def from_config(cfg) -> "ImageOptions":
        return ImageOptions(
            light=cfg.require("image_light"),
            time=bool(cfg.image_time),
            length=bool(cfg.image_length),
            lam=bool(cfg.image_lambda),
            emission=bool(cfg.image_emission),
            tau=bool(cfg.image_tau),
            lambda_ave=bool(cfg.image_lambda_ave),
            emission_ave=bool(cfg.image_emission_ave),
            tau_int=bool(cfg.image_tau_int),
            crossings=bool(cfg.image_crossings),
            fallback_nan=cfg.require("fallback_nan"),
        )


def integrate_unpolarized(positions, directions, momentum_factors, frequencies,
                          params: geodesic.GeodesicParams, coeff_fn: Callable,
                          opts: ImageOptions, mass_msun: float, camera_x,
                          cell_fn: Optional[Callable] = None,
                          early_exit: bool = False, log_j_scale=0.0,
                          stored=None, stored_prims=None, wavefront=None,
                          wavefront_batch: bool = True):
    """Fused geodesic + unpolarized RT over a pixel bundle.

    Args:
      positions: (B, 4) camera pixel events.
      directions: (B, 4) covariant photon momenta.
      momentum_factors: (B,) frequency normalization factors.
      frequencies: (F,) image frequencies [Hz].
      params: geodesic integration parameters.
      coeff_fn: (pos (B,4), kcov (B,4)) -> (j (B,F), alpha (B,F)) invariant
        coefficients (zeros where cut).
      opts: which image planes to produce.
      mass_msun: black-hole mass in solar masses (unit system).
      camera_x: (4,) camera position (crossings plane).
      cell_fn: optional (pos, kcov) -> (B, NUM_CELL_VALUES) diagnostic values
        (NaN where invalid) for the *_ave / tau_int images.
      log_j_scale: natural log of the unit factor by which coeff_fn's j
        values were divided to keep them O(1) in float32; folded back into
        I_nu/emission at the end (the transfer is linear in j, and the
        source function S = j/alpha is rescaled consistently). Passed in log
        form because the factor itself (~1e-41 CGS) underflows float32.
      stored: optional (samples, flags, n_samples) from a geodesic
        checkpoint (checkpoint.load_geodesics); when given the geodesic
        integration is skipped and the scan runs over the stored (S, B)
        sample arrays instead.
      stored_prims: optional dict of (S, B) sampled primitive arrays from a
        sampling checkpoint; requires stored, and coeff_fn/cell_fn must
        accept a prims keyword.
      wavefront: optional (prep_fn, prims_fn, window) from
        grid.wavefront.make_wavefront_prep: run the windowed deduplicated
        sampler (geodesic.windowed_reduce) instead of the per-step scan.
        coeff_fn/cell_fn must accept a prims keyword. Forward-only; adds
        "_wavefront_overflow" (B,) to the output (all-True when some
        window's dedup table overflowed and the caller must re-render on
        the exact path).
      wavefront_batch: evaluate the coefficient chain (synchrotron
        transcendentals, Bessel ratios, ...) for the WHOLE window in one
        vmapped (W, B) batch inside the window prep instead of per step
        inside the scan - same elementwise ops on the same values (the
        image is identical), but W small per-step launches collapse into
        a few large fused ones, leaving only the radiative-transfer
        recurrence in the per-step body.

    Returns:
      dict of image arrays keyed by output names ("I_nu", "time", ...),
      each (B,) or (B, F) or (B, F, C); plus "_flags" (B,) bad-ray flags and
      "_n_samples" (B,).
    """
    b = positions.shape[0]
    f = frequencies.shape[0]
    dtype = positions.dtype
    x_unit = Physics.gg_msun * mass_msun / (Physics.c * Physics.c)
    t_unit = x_unit / Physics.c

    need_cells = opts.lambda_ave or opts.emission_ave or opts.tau_int
    if need_cells and cell_fn is None:
        raise ValueError("cell_fn required for lambda_ave/emission_ave/tau_int")

    need_coeffs = (opts.light or opts.emission or opts.emission_ave
                   or opts.tau or opts.tau_int)

    state = {}
    if need_coeffs:
        # Non-finite coefficients (e.g. pow(negative, non-integer) matching
        # C++ semantics at horizon-adjacent samples) must poison the pixel
        # exactly as NaN propagation would in the reference - but as an
        # explicit flag + final NaN, so the recurrence math stays NaN-free
        # and reverse-mode stays finite.
        state["coeff_bad"] = jnp.zeros((b, f), dtype=bool)
    if opts.light:
        state["I"] = jnp.zeros((b, f), dtype)
        state["tau_accum"] = jnp.zeros((b, f), dtype)
    if opts.time:
        state["time"] = jnp.zeros(b, dtype)
    if opts.length:
        state["length"] = jnp.zeros(b, dtype)
    if opts.lam or opts.lambda_ave:
        state["lambda"] = jnp.zeros((b, f), dtype)
    if opts.emission or opts.emission_ave:
        state["emission"] = jnp.zeros((b, f), dtype)
    if opts.tau:
        state["tau"] = jnp.zeros((b, f), dtype)
    if opts.lambda_ave:
        state["lambda_ave"] = jnp.zeros((b, f, NUM_CELL_VALUES), dtype)
    if opts.emission_ave:
        state["emission_ave"] = jnp.zeros((b, f, NUM_CELL_VALUES), dtype)
    if opts.tau_int:
        state["tau_int"] = jnp.zeros((b, f, NUM_CELL_VALUES), dtype)
        state["tau_int_tau"] = jnp.zeros((b, f), dtype)
    if opts.crossings:
        state["crossings"] = jnp.zeros(b, jnp.int32)
        state["plane_sign"] = jnp.zeros(b, dtype=bool)
        state["sign_set"] = jnp.zeros(b, dtype=bool)
    if opts.track_sample_times:
        state["t_min"] = jnp.full(b, jnp.inf, dtype)
        state["t_max"] = jnp.full(b, -jnp.inf, dtype)

    safe_pos = jnp.asarray(camera_x, dtype)
    safe_dir = jnp.asarray(jnp.array([-1.0, 1.0, 0.0, 0.0], dtype))

    def contribution(state, sample: geodesic.Sample, prims=None, pre=None):
        state = dict(state)
        valid = sample.valid
        validf = valid.astype(dtype)
        # Invalid samples hold dead rays' last state (possibly inside the
        # horizon); evaluating coefficients there can produce non-finite
        # primals whose adjoints NaN-poison the backward scan even though
        # the forward select masks them. Evaluate at a safe point instead.
        pos = jnp.where(valid[:, None], sample.pos, safe_pos[None, :])
        kcov = jnp.where(valid[:, None], sample.dir, safe_dir[None, :])
        extra = {} if prims is None else {"prims": prims}
        # Reference reverses geodesics flipping len sign
        # (geodesics.cpp:840); use the positive affine step directly.
        delta_lambda = -sample.len
        # (B, F) CGS path increment (unpolarized.cpp:75-76)
        dl_cgs = (delta_lambda[:, None] * x_unit
                  / (frequencies[None, :] * momentum_factors[:, None]))

        if need_coeffs:
            if pre is not None:
                j, alpha, cbad = pre["j"], pre["alpha"], pre["cbad"]
            else:
                res = coeff_fn(pos, kcov, **extra)
                if len(res) == 3:
                    j, alpha, cbad = res
                else:
                    j, alpha = res
                    cbad = jnp.zeros(j.shape, dtype=bool)
            bad = cbad | ~(jnp.isfinite(j) & jnp.isfinite(alpha))
            j = jnp.where(bad, 0.0, j)
            alpha = jnp.where(bad, 0.0, alpha)
            state["coeff_bad"] = state["coeff_bad"] | (valid[:, None] & bad)
        if need_cells:
            cells = pre["cells"] if pre is not None \
                else cell_fn(pos, kcov, **extra)  # (B, C)
            cells_ok = valid[:, None] & ~jnp.isnan(cells[:, 0:1])
            # Sanitize before any product: NaN primals poison adjoints
            cells = jnp.where(jnp.isnan(cells), 0.0, cells)

        if opts.light:
            pos_alpha_pre = alpha > 0.0
            # double-where: j/alpha with alpha == 0 is masked out below, but
            # its NaN would still poison gradients through the select
            ss = j / jnp.where(pos_alpha_pre, alpha, 1.0)
            delta_tau = alpha * dl_cgs
            atten = jnp.exp(-state["tau_accum"])
            pos_alpha = alpha > 0.0
            thin = delta_tau <= DELTA_TAU_MAX
            # contribution per branch (see module docstring)
            contrib_thin = ss * (-jnp.expm1(-delta_tau))
            contrib_thick = ss
            contrib_neg = j * dl_cgs
            contrib = jnp.where(pos_alpha,
                                jnp.where(thin, contrib_thin, contrib_thick),
                                contrib_neg)
            state["I"] = state["I"] + jnp.where(valid[:, None],
                                                 contrib * atten, 0.0)
            dtau_eff = jnp.where(pos_alpha,
                                 jnp.where(thin, delta_tau, jnp.inf),
                                 0.0)
            state["tau_accum"] = state["tau_accum"] + jnp.where(
                valid[:, None], dtau_eff, 0.0)

        if opts.time:
            t_cgs = pos[:, 0] * t_unit
            state["time"] = jnp.where(valid, jnp.minimum(state["time"], t_cgs),
                                      state["time"])
        if opts.length:
            # Proper-length increment (unpolarized.cpp:117-129)
            g_cov, g_con = geometry.gcov_gcon(pos[:, 1:], params.bh_a, params.bh_m,
                                              flat=params.ray_flat)
            q = (jnp.einsum("...am,...m->...a", g_con[:, 1:, :], kcov,
                            precision=HIGHEST)
                 - g_con[:, 0, 1:] * (jnp.einsum("...m,...m->...",
                                                 g_con[:, 0, :], kcov,
                                                 precision=HIGHEST)
                                      / g_con[:, 0, 0])[:, None])
            dl2 = jnp.einsum("...ab,...a,...b->...", g_cov[:, 1:, 1:], q, q,
                             precision=HIGHEST)
            state["length"] = state["length"] + jnp.where(
                valid, jnp.sqrt(jnp.maximum(dl2, 1e-300)) * delta_lambda * x_unit,
                0.0)
        if opts.lam or opts.lambda_ave:
            state["lambda"] = state["lambda"] + validf[:, None] * dl_cgs
        if opts.emission or opts.emission_ave:
            state["emission"] = state["emission"] + jnp.where(
                valid[:, None], j * dl_cgs, 0.0)
        if opts.tau:
            state["tau"] = state["tau"] + jnp.where(
                valid[:, None], alpha * dl_cgs, 0.0)
        if opts.lambda_ave:
            upd = jnp.where(cells_ok[:, :, None],
                            cells[:, None, :] * dl_cgs[..., None], 0.0)
            state["lambda_ave"] = state["lambda_ave"] + upd
        if opts.emission_ave:
            upd = jnp.where(cells_ok[:, :, None],
                            cells[:, None, :] * (j * dl_cgs)[..., None], 0.0)
            state["emission_ave"] = state["emission_ave"] + upd
        if opts.tau_int:
            delta_tau = alpha * dl_cgs
            thin = delta_tau <= DELTA_TAU_MAX
            atten = jnp.exp(-state["tau_int_tau"])
            contrib_thin = -jnp.expm1(-delta_tau)
            contrib = jnp.where(thin, contrib_thin, 1.0)
            upd = jnp.where(cells_ok[:, :, None],
                            (contrib * atten)[..., None] * cells[:, None, :], 0.0)
            state["tau_int"] = state["tau_int"] + upd
            dtau_eff = jnp.where(thin, delta_tau, jnp.inf)
            state["tau_int_tau"] = state["tau_int_tau"] + jnp.where(
                cells_ok, dtau_eff, 0.0)
        if opts.crossings:
            sign_new = (camera_x[1] * pos[:, 1] + camera_x[2] * pos[:, 2]
                        + camera_x[3] * pos[:, 3]) > 0.0
            flipped = valid & state["sign_set"] & (sign_new != state["plane_sign"])
            state["crossings"] = state["crossings"] + flipped.astype(jnp.int32)
            state["plane_sign"] = jnp.where(valid, sign_new, state["plane_sign"])
            state["sign_set"] = state["sign_set"] | valid
        if opts.track_sample_times:
            t = sample.pos[:, 0]
            state["t_min"] = jnp.where(valid, jnp.minimum(state["t_min"], t),
                                       state["t_min"])
            state["t_max"] = jnp.where(valid, jnp.maximum(state["t_max"], t),
                                       state["t_max"])
        return state

    if stored is not None:
        samples, flags, n_samples = stored

        def body(st, xs):
            if stored_prims is not None:
                sample, prims = xs
                return contribution(st, sample, prims), None
            return contribution(st, xs), None

        xs = (samples, stored_prims) if stored_prims is not None else samples
        state, _ = jax.lax.scan(body, state, xs)
    elif wavefront is not None:
        prep_fn, prims_fn, window = wavefront

        if wavefront_batch and (need_coeffs or need_cells):
            # Hoist the heavy per-sample math out of the inner scan: expand
            # the window's prims step by step (cheap MXU one-hot +
            # trilinear), then run the coefficient chain over the whole
            # (W, B) window in one vmapped batch. Same elementwise ops on
            # the same values - the image is bit-identical - but the scan
            # body shrinks to the radiative-transfer recurrence.
            def batched_prep(samples):
                aux_steps, aux_const, flag = prep_fn(samples)
                _, prims = jax.lax.scan(
                    lambda c, a: (c, prims_fn(a, aux_const, dtype)),
                    0, aux_steps)
                valid = samples.valid
                # Same safe-point substitution contribution() applies per
                # step (invalid samples park at possibly-horizon states).
                pos = jnp.where(valid[..., None], samples.pos,
                                safe_pos[None, None, :])
                kcov = jnp.where(valid[..., None], samples.dir,
                                 safe_dir[None, None, :])
                pre = {}
                if need_coeffs:
                    res = jax.vmap(
                        lambda p, k, pr: coeff_fn(p, k, prims=pr))(
                            pos, kcov, prims)
                    if len(res) == 3:
                        pre["j"], pre["alpha"], pre["cbad"] = res
                    else:
                        pre["j"], pre["alpha"] = res
                        pre["cbad"] = jnp.zeros(pre["j"].shape, dtype=bool)
                if need_cells:
                    pre["cells"] = jax.vmap(
                        lambda p, k, pr: cell_fn(p, k, prims=pr))(
                            pos, kcov, prims)
                return {"pre": pre}, aux_const, flag

            def wf_contribution(st, sample, aux_step, aux_const):
                return contribution(st, sample, pre=aux_step["pre"])

            state, flags, n_samples, overflow = geodesic.windowed_reduce(
                positions, directions, params, batched_prep, wf_contribution,
                state, window)
        else:
            def wf_contribution(st, sample, aux_step, aux_const):
                return contribution(st, sample,
                                    prims=prims_fn(aux_step, aux_const,
                                                   dtype))

            state, flags, n_samples, overflow = geodesic.windowed_reduce(
                positions, directions, params, prep_fn, wf_contribution,
                state, window)
    else:
        state, flags, n_samples = geodesic.streaming_reduce(
            positions, directions, params, contribution, state,
            early_exit=early_exit)

    # Final transforms (unpolarized.cpp:176-209) + NaN poisoning of flagged rays
    out = {"_flags": flags, "_n_samples": n_samples}
    if wavefront is not None:
        out["_wavefront_overflow"] = jnp.broadcast_to(overflow, flags.shape)
    nan = jnp.array(jnp.nan, dtype)
    poison = (flags & opts.fallback_nan)[:, None]
    # Coefficient-dependent outputs also poison where coefficients went
    # non-finite at a contributing sample (as NaN propagation would in the
    # reference)
    poison_c = poison | state["coeff_bad"] if need_coeffs else poison
    if opts.light:
        # Combine the unit scale with the nu^3 factor in log space: the
        # factor alone (~1e-41 CGS) underflows float32, but the product
        # with nu^3 is representable.
        scale = jnp.exp(jnp.asarray(log_j_scale, dtype)
                        + 3.0 * jnp.log(frequencies[None, :].astype(dtype)))
        img = state["I"] * scale
        out["I_nu"] = jnp.where(poison_c, nan, img)
    if opts.time:
        out["time"] = state["time"]
    if opts.length:
        out["length"] = state["length"]
    if opts.lam:
        out["lambda"] = state["lambda"]
    if opts.emission:
        out["emission"] = jnp.where(
            poison_c, nan,
            state["emission"] * jnp.exp(jnp.asarray(log_j_scale, dtype)))
    if opts.tau:
        out["tau"] = jnp.where(poison_c, nan, state["tau"])
    if opts.lambda_ave:
        ave = state["lambda_ave"] / state["lambda"][..., None]
        out["lambda_ave"] = jnp.where(poison[..., None], 0.0, ave)
    if opts.emission_ave:
        ave = state["emission_ave"] / state["emission"][..., None]
        out["emission_ave"] = jnp.where(poison_c[..., None], nan, ave)
    if opts.tau_int:
        out["tau_int"] = jnp.where(poison_c[..., None], nan, state["tau_int"])
    if opts.crossings:
        out["crossings"] = state["crossings"].astype(dtype)
    if opts.track_sample_times:
        out["_t_min"] = state["t_min"]
        out["_t_max"] = state["t_max"]
    return out
