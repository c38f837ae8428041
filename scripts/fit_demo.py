#!/usr/bin/env python
"""Inverse rendering demo: recover emission-model parameters from an image.

Demonstrates the capability the reference cannot offer: the whole
geodesic + radiative-transfer pipeline is differentiable, so a synthetic
"observation" rendered with hidden parameters can be fit by gradient
descent on the renderer itself.

    python scripts/fit_demo.py   # ~1 minute on CPU

Fits log(cn0) (emission amplitude) and formula_r0 (disk radius) of the
analytic disk model to a 32x32 target image by Adam on an L2 image loss,
with gradients from jax.grad through the geodesic + transfer scan.
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from blacklight import pipeline  # noqa: E402
from blacklight.camera import make_camera  # noqa: E402
from blacklight.models import formula as formula_model  # noqa: E402
from blacklight.transfer.unpolarized import (  # noqa: E402
    ImageOptions, integrate_unpolarized)
from blacklight.utils.config import parse_config  # noqa: E402

CONFIG = """
model_type = formula
formula_mass  = 6.0e11
formula_spin  = 0.9
formula_r0    = 10.0
formula_h     = 0.0
formula_l0    = 0.0
formula_q     = 0.5
formula_nup   = 2.3e11
formula_cn0   = 3.0e-18
formula_alpha = -3.0
formula_a     = 0.0
formula_beta  = 2.5
camera_type       = plane
camera_r          = 100.0
camera_th         = 60.0
camera_ph         = 0.0
camera_urn        = 0.0
camera_uthn       = 0.0
camera_uphn       = 0.0
camera_k_r        = 1.0
camera_k_th       = 0.0
camera_k_ph       = 0.0
camera_rotation   = 0.0
camera_width      = 25.0
camera_resolution = 32
ray_flat        = false
ray_terminate   = additive
ray_factor      = 5.0e-4
ray_integrator  = rk4
ray_step        = 0.01
ray_max_steps   = 2600
image_light           = true
image_num_frequencies = 1
image_frequency       = 2.3e11
image_normalization   = camera
render_num_images = 0
adaptive_max_level = 0
cut_omit_near = false
cut_omit_far  = false
cut_omit_in   = -1.0
cut_omit_out  = -1.0
cut_midplane_theta = 0.0
cut_midplane_z = 0.0
cut_plane = false
fallback_nan = false
precision = float64
"""


def main():
    jax.config.update("jax_enable_x64", True)
    cfg = parse_config(CONFIG)
    bh_m, bh_a, mass_msun = pipeline.bh_mass_spin(cfg)
    geom, rays, freqs = make_camera(cfg, bh_m=bh_m, bh_a=bh_a)
    params = pipeline.geodesic_params_from_config(cfg, bh_m, bh_a)
    fparams0 = formula_model.formula_params_from_config(cfg)

    def render(log_cn0, log_r0):
        fp = dataclasses.replace(fparams0, cn0=jnp.exp(log_cn0),
                                 r0=jnp.exp(log_r0))

        def coeff_fn(pos, kcov):
            j, a, _, bad = formula_model.formula_coefficients(
                pos, kcov, rays.momentum_factors, freqs, fp, geom.cam_x)
            return j, a, bad

        img = integrate_unpolarized(
            rays.positions, rays.directions, rays.momentum_factors, freqs,
            params=params, coeff_fn=coeff_fn,
            opts=ImageOptions(fallback_nan=False),
            mass_msun=mass_msun, camera_x=geom.cam_x,
            log_j_scale=formula_model.formula_log_j_scale(fp))
        return img["I_nu"][:, 0]

    # Hidden truth: different amplitude and disk radius
    true_log_cn0 = float(np.log(fparams0.cn0 * 2.5))
    true_log_r0 = float(np.log(13.0))
    target = jax.jit(render)(true_log_cn0, true_log_r0)
    scale = float(jnp.nanmax(target))

    def loss(theta):
        img = render(theta[0], theta[1])
        return jnp.nanmean(((img - target) / scale) ** 2)

    value_grad = jax.jit(jax.value_and_grad(loss))
    theta = jnp.array([float(np.log(fparams0.cn0)), float(np.log(10.0))])
    m = jnp.zeros_like(theta)
    v = jnp.zeros_like(theta)
    lr, b1, b2, eps = 0.05, 0.9, 0.999, 1e-8
    print(f"truth:  log_cn0 = {true_log_cn0:.4f}, log_r0 = {true_log_r0:.4f}")
    for i in range(1, 201):
        val, g = value_grad(theta)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1 ** i)
        vh = v / (1 - b2 ** i)
        theta = theta - lr * mh / (jnp.sqrt(vh) + eps)
        if i % 25 == 0 or i == 1:
            print(f"step {i:3d}: loss = {float(val):.3e}  "
                  f"log_cn0 = {float(theta[0]):.4f}  "
                  f"log_r0 = {float(theta[1]):.4f}")
    err_cn0 = abs(float(theta[0]) - true_log_cn0)
    err_r0 = abs(float(theta[1]) - true_log_r0)
    print(f"final errors: |dlog_cn0| = {err_cn0:.2e}, |dlog_r0| = {err_r0:.2e}")
    ok = err_cn0 < 2e-2 and err_r0 < 2e-2
    print("FIT OK" if ok else "FIT DID NOT CONVERGE")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
