"""False-color volume rendering (reference radiation_integrator/rendering.cpp:25-179).

Produces per-image XYZ colors along rays from the 7 diagnostic cell values:
`fill` features accumulate optical-depth-weighted color (exponential
recurrence with tau = proper length / tau_scale), `thresh`/`rise`/`fall`
features alpha-blend their color when the quantity crosses a threshold
between consecutive samples.

Threshold detection needs the previous (farther) sample's cell values, so
this runs as a reverse scan over materialized samples (reference order),
like the polarized path.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp

from blacklight.constants import (
    HIGHEST, Physics, RayIntegrator, RenderType)
from blacklight.ops import geodesic, geometry

DELTA_TAU_MAX = 100.0


def integrate_rendering(positions, directions, params: geodesic.GeodesicParams,
                        cell_fn: Callable, render_images: Sequence,
                        mass_msun: float, stored=None):
    """Render false-color images over a pixel bundle.

    Args:
      cell_fn: (pos (B,4), kcov (B,4)) -> (B, 7) cell values (NaN where unset).
      render_images: list of RenderImage configs (utils.config).

    Returns ((B, n_images, 3) XYZ array, flags, n_samples).
    """
    b = positions.shape[0]
    dtype = positions.dtype
    n_images = len(render_images)
    x_unit = Physics.gg_msun * mass_msun / (Physics.c * Physics.c)
    fill_present = any(
        feat.render_type == RenderType.fill
        for img in render_images for feat in img.features)

    if stored is not None:
        samples, flags, n_samples = stored
    else:
        samples, flags, n_samples = geodesic.trace_geodesics(
            positions, directions, params)
        if params.integrator == RayIntegrator.dp:
            # Only dp leaves holes (rejected attempts); rk samples are
            # already prefix-valid, so they skip the argsort compaction
            samples = geodesic.compact_samples(samples)

    state = {
        "rgb": jnp.zeros((b, n_images, 3), dtype),
        "prev": jnp.full((b, 7), jnp.nan, dtype),
    }

    def body(state, xs):
        pos, kcov, length, valid = xs
        delta_lambda = -length
        cells = cell_fn(pos, kcov)  # (B, 7)

        if fill_present:
            g_cov, g_con = geometry.gcov_gcon(pos[:, 1:4], params.bh_a,
                                              params.bh_m, flat=params.ray_flat)
            q = (jnp.einsum("Bam,Bm->Ba", g_con[:, 1:, :], kcov,
                            precision=HIGHEST)
                 - g_con[:, 0, 1:] * (jnp.einsum("Bm,Bm->B", g_con[:, 0, :],
                                                 kcov, precision=HIGHEST)
                                      / g_con[:, 0, 0])[:, None])
            dl2 = jnp.einsum("Bab,Ba,Bb->B", g_cov[:, 1:, 1:], q, q,
                             precision=HIGHEST)
            delta_length = jnp.sqrt(jnp.maximum(dl2, 0.0)) * delta_lambda * x_unit
        else:
            delta_length = jnp.zeros_like(delta_lambda)

        rgb = state["rgb"]
        for n_i, img in enumerate(render_images):
            chan = rgb[:, n_i, :]
            for feat in img.features:
                n_v = feat.quantity
                cur = cells[:, n_v]
                prev = state["prev"][:, n_v]
                color = jnp.asarray([feat.x_val, feat.y_val, feat.z_val],
                                    dtype=dtype)
                if feat.render_type == RenderType.fill:
                    in_range = valid & (cur >= feat.min_val) & (cur <= feat.max_val)
                    delta_tau = delta_length / feat.tau_scale
                    thin = delta_tau <= DELTA_TAU_MAX
                    exp_neg = jnp.exp(-delta_tau)
                    expm1 = jnp.expm1(delta_tau)
                    new_thin = exp_neg[:, None] * (chan + color[None, :]
                                                   * expm1[:, None])
                    new = jnp.where(thin[:, None], new_thin,
                                    jnp.broadcast_to(color, chan.shape))
                    chan = jnp.where(in_range[:, None], new, chan)
                else:
                    crossed = jnp.zeros_like(valid)
                    if feat.render_type in (RenderType.thresh, RenderType.rise):
                        crossed |= (prev < feat.thresh_val) & (cur >= feat.thresh_val)
                    if feat.render_type in (RenderType.thresh, RenderType.fall):
                        crossed |= (prev > feat.thresh_val) & (cur <= feat.thresh_val)
                    crossed &= valid
                    blended = (1.0 - feat.opacity) * chan \
                        + feat.opacity * color[None, :]
                    chan = jnp.where(crossed[:, None], blended, chan)
            rgb = rgb.at[:, n_i, :].set(chan)

        state = dict(state)
        state["rgb"] = rgb
        state["prev"] = jnp.where(valid[:, None], cells, state["prev"])
        return state, None

    xs = (samples.pos, samples.dir, samples.len, samples.valid)
    state, _ = jax.lax.scan(body, state, xs, reverse=True)
    return state["rgb"], flags, n_samples
