"""End-to-end orchestration: config -> camera -> fused ray trace -> output.

Plays the role of the reference's main() (src/blacklight.cpp:31-273) with the
same per-stage timing report, but the geodesic and radiation stages are a
single fused jitted computation on the formula/unpolarized path.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from blacklight.constants import ModelType, Physics, RayIntegrator
from blacklight.camera import make_camera
from blacklight.models import formula as formula_model
from blacklight.ops import geodesic
from blacklight.output import (
    assemble_npz_arrays,
    format_filename,
    validate_output_options,
    write_output,
)
from blacklight.transfer.unpolarized import ImageOptions, integrate_unpolarized
from blacklight.utils.errors import BlacklightError, blacklight_warning


def compute_dtype(cfg):
    precision = cfg.precision or "float64"
    if precision == "float32":
        return jnp.float32
    if precision == "float64":
        return jnp.float64
    raise BlacklightError(f"Unknown precision ({precision}) in input file.")


def geodesic_params_from_config(cfg, bh_m: float, bh_a: float) -> geodesic.GeodesicParams:
    integrator = cfg.require("ray_integrator")
    kwargs = {}
    if integrator == RayIntegrator.dp:
        kwargs = dict(ray_tol_abs=cfg.require("ray_tol_abs"),
                      ray_tol_rel=cfg.require("ray_tol_rel"),
                      ray_max_retries=cfg.require("ray_max_retries"))
    from blacklight.constants import RayTerminate
    ray_terminate = cfg.require("ray_terminate")
    ray_factor = cfg.require("ray_factor") if ray_terminate != RayTerminate.photon \
        else 0.0
    return geodesic.GeodesicParams(
        integrator=integrator, bh_m=bh_m, bh_a=bh_a,
        ray_flat=cfg.require("ray_flat"),
        ray_step=cfg.require("ray_step"),
        ray_max_steps=cfg.require("ray_max_steps"),
        r_terminate=geodesic.terminate_radius(ray_terminate, ray_factor, bh_m, bh_a),
        camera_r=cfg.require("camera_r"),
        r_horizon=geodesic.horizon_radius(bh_m, bh_a),
        **kwargs)


def bh_mass_spin(cfg):
    """(bh_m, bh_a, mass_msun) per model type (geodesic_integrator.cpp:107-116,
    radiation_integrator.cpp:420-431)."""
    model = cfg.require("model_type")
    if model == ModelType.simulation:
        bh_a = cfg.require("simulation_a")
        mass_msun = cfg.require("simulation_m_msun")
    else:
        bh_a = cfg.require("formula_spin")
        mass_msun = cfg.require("formula_mass") * Physics.c ** 2 / Physics.gg_msun
    return 1.0, bh_a, mass_msun


def make_formula_renderer(cfg, early_exit: bool = True):
    """Build a reusable unpolarized formula-model renderer.

    Returns (render_fn, geom, rays, frequencies, mass_msun) where
    render_fn(positions, directions, momentum_factors) renders any pixel
    bundle (root camera or adaptive child blocks) to a NumPy image dict.
    """
    dtype = compute_dtype(cfg)
    bh_m, bh_a, mass_msun = bh_mass_spin(cfg)
    geom, rays, frequencies = make_camera(cfg, bh_m=bh_m, bh_a=bh_a, dtype=dtype)
    params = geodesic_params_from_config(cfg, bh_m, bh_a)
    fparams = formula_model.formula_params_from_config(cfg)
    opts = ImageOptions.from_config(cfg)
    camera_x = geom.cam_x

    # One jit per renderer: momentum factors and stored samples are traced
    # arguments, so every pixel bundle of a given shape reuses the same
    # executable (tile dispatch would otherwise recompile per tile)
    @functools.lru_cache(maxsize=4)
    def fused_for(has_stored):
        def fused(positions, directions, momentum_factors, stored):
            def coeff_fn(pos, kcov, mom=momentum_factors):
                j, alpha, _, bad = formula_model.formula_coefficients(
                    pos, kcov, mom, frequencies, fparams, camera_x)
                return j, alpha, bad

            return integrate_unpolarized(
                positions, directions, momentum_factors, frequencies,
                params=params, coeff_fn=coeff_fn, opts=opts,
                mass_msun=mass_msun, camera_x=camera_x,
                early_exit=early_exit,
                log_j_scale=formula_model.formula_log_j_scale(fparams),
                stored=stored)
        if has_stored:
            return jax.jit(fused)
        return jax.jit(lambda p, d, m: fused(p, d, m, None))

    def render_fn(positions, directions, momentum_factors, stored=None):
        if stored is None:
            image = fused_for(False)(positions, directions, momentum_factors)
        else:
            image = fused_for(True)(positions, directions, momentum_factors,
                                    stored)
        return jax.tree.map(lambda a: np.asarray(a), image)

    render_fn.geodesic_params = params
    render_fn.lower = lambda p, d, m: fused_for(False).lower(p, d, m)
    return render_fn, geom, rays, frequencies, mass_msun


def render_formula_image(cfg, *, positions=None, directions=None,
                         momentum_factors=None, early_exit: bool = True):
    """Unpolarized formula-model image over the root (or given) pixel bundle.

    Returns (image_dict, camera_rays, frequencies, mass_msun).
    """
    render_fn, geom, rays, frequencies, mass_msun = make_formula_renderer(
        cfg, early_exit=early_exit)
    if positions is None:
        positions = rays.positions
        directions = rays.directions
        momentum_factors = rays.momentum_factors
    image = render_fn(positions, directions, momentum_factors)
    return image, rays, frequencies, mass_msun


def adaptive_loop(cfg, render_fn, geom, root_image):
    """Adaptive refinement driver (reference blacklight.cpp:198-236 loop):
    evaluate blocks at each level, respawn 4 children per flagged block at
    doubled resolution, re-render only the new pixels.

    Returns the list of per-level dicts consumed by assemble_npz_arrays.
    """
    from blacklight import adaptive as ad
    from blacklight.camera import block_pixel_grid, init_pixels
    from blacklight.output import shape_adaptive_level

    p_ad = ad.AdaptiveParams.from_config(cfg)
    if p_ad.max_level == 0:
        return []
    res = cfg.require("camera_resolution")
    width = cfg.require("camera_width")
    freq_idx = p_ad.frequency_num - 1
    bs = p_ad.block_size
    bh_m, bh_a, _ = bh_mass_spin(cfg)
    dtype = compute_dtype(cfg)

    def criteria_intensity(image):
        # I_nu at the adaptive frequency; Stokes I when polarized
        # (radiation_adaptive.cpp:72-77)
        return np.asarray(image["I_nu"])[:, freq_idx]

    locs = ad.root_block_locs(res, bs)
    blocks = ad.extract_root_blocks(criteria_intensity(root_image), res, bs)
    levels = []
    level = 0
    while level < p_ad.max_level:
        flags = ad.check_refinement(blocks, locs, level, res, width, p_ad)
        if not flags.any():
            break
        locs = ad.child_block_locs(locs, flags)
        level += 1
        eff_res = res * (1 << level)
        u_ind, v_ind = block_pixel_grid(locs[:, 1], locs[:, 0], bs, eff_res,
                                        dtype=dtype)
        child_rays = init_pixels(
            geom, u_ind, v_ind, camera_type=cfg.require("camera_type"),
            bh_m=bh_m, bh_a=bh_a, camera_width=width,
            camera_r=cfg.require("camera_r"),
            image_normalization=cfg.require("image_normalization"),
            ray_flat=cfg.require("ray_flat"))
        # Bucket the ragged child-bundle size to the next power of two of
        # blocks so deep refinements reuse a handful of executables
        # instead of compiling one per level's exact block count
        # (padding rays repeat ray 0 and are sliced off).
        n_blocks = locs.shape[0]
        n_pix = n_blocks * bs * bs
        pad_blocks = 1 << max(n_blocks - 1, 0).bit_length()
        n_pad = pad_blocks * bs * bs - n_pix

        def padded(a):
            if n_pad == 0:
                return a
            reps = np.broadcast_to(np.asarray(a)[:1],
                                   (n_pad,) + a.shape[1:])
            return np.concatenate([np.asarray(a), reps], axis=0)

        image_l = render_fn(padded(child_rays.positions),
                            padded(child_rays.directions),
                            padded(child_rays.momentum_factors))
        if n_pad:
            image_l = {k: v[:n_pix] for k, v in image_l.items()}
        rendering = None
        if "rendering" in image_l:
            rendering = np.transpose(np.asarray(image_l["rendering"]),
                                     (1, 2, 0))
        lvl = {"num_blocks": n_blocks, "block_locs": locs}
        lvl.update(shape_adaptive_level(cfg, image_l, n_blocks, bs,
                                        camera_rays=child_rays,
                                        rendering=rendering))
        levels.append(lvl)
        blocks = ad.blocks_from_bundle(criteria_intensity(image_l),
                                       n_blocks, bs)
    return levels


def run(cfg, snapshot: Optional[int] = None, quiet: bool = False) -> dict:
    """Full run for one snapshot.

    Returns the dict of named output arrays written to disk.
    """
    from blacklight import checkpoint as ckpt

    import contextlib
    import os

    validate_output_options(cfg)
    ckpt.validate_checkpoint_options(cfg)
    from blacklight.utils.config import warn_ignored_options
    warn_ignored_options(cfg)
    model = cfg.require("model_type")

    # Optional on-device profiling (SURVEY 5.1: the reference has wall-clock
    # stage timers only; here a jax.profiler trace adds per-kernel detail)
    profile_dir = os.environ.get("BLACKLIGHT_PROFILE_DIR")
    profile_cm = jax.profiler.trace(profile_dir) if profile_dir \
        else contextlib.nullcontext()

    t0 = time.time()
    if model == ModelType.formula:
        render_fn, geom, rays, frequencies, mass_msun = make_formula_renderer(cfg)
        t_read = 0.0
    else:
        from blacklight.pipeline_simulation import make_simulation_renderer
        render_fn, geom, rays, frequencies, mass_msun = make_simulation_renderer(
            cfg, snapshot=snapshot)
        t_read = time.time() - t0

    # Checkpoints apply to the root-level bundle only, like the reference's
    # level-0 arrays (geodesic_checkpoint.cpp:28-59)
    stored = None
    if cfg.require("checkpoint_geodesic_load"):
        stored = ckpt.load_geodesics(cfg.require("checkpoint_geodesic_file"),
                                     dtype=compute_dtype(cfg))
    elif cfg.require("checkpoint_geodesic_save"):
        stored = ckpt.trace_and_save_geodesics(
            cfg.require("checkpoint_geodesic_file"), rays.positions,
            rays.directions, rays.momentum_factors, render_fn.geodesic_params)
    stored_prims = None
    if model == ModelType.simulation and (cfg.checkpoint_sample_load
                                          or cfg.checkpoint_sample_save):
        if stored is None:
            import jax as _jax
            from blacklight.ops import geodesic as _geo
            samples, flags, n_samples = _jax.jit(
                lambda p, d: _geo.trace_geodesics(
                    p, d, render_fn.geodesic_params))(
                        rays.positions, rays.directions)
            stored = (_geo.compact_samples(samples), flags, n_samples)
        if cfg.checkpoint_sample_load:
            stored_prims = ckpt.load_samples(cfg.require("checkpoint_sample_file"))
        else:
            stored_prims = render_fn.sample_stored(stored)
            ckpt.save_samples(cfg.require("checkpoint_sample_file"), stored_prims)

    kwargs = {}
    if stored is not None:
        kwargs["stored"] = stored
    if stored_prims is not None:
        kwargs["stored_prims"] = stored_prims
    t1 = time.time()
    with profile_cm:
        image = render_fn(rays.positions, rays.directions,
                          rays.momentum_factors, **kwargs)
        adaptive_levels = adaptive_loop(cfg, render_fn, geom, image)
    t_image = time.time() - t1

    n_bad = int(np.sum(image["_flags"]))
    if n_bad > 0:
        blacklight_warning(
            f"{n_bad} out of {len(image['_flags'])} geodesics terminate unexpectedly.")

    rendering = None
    if "rendering" in image:
        # (num_pix, n_img, 3) -> (n_img, 3, num_pix)
        rendering = np.transpose(np.asarray(image["rendering"]), (1, 2, 0))
    arrays = assemble_npz_arrays(cfg, image, mass_msun=mass_msun,
                                 frequencies=frequencies, camera_rays=rays,
                                 rendering=rendering,
                                 adaptive_levels=adaptive_levels)
    # Output numbering: snapshot + slow_offset (slow light) or
    # + simulation_start (multiple files) (output_writer.cpp:248-254)
    file_number = snapshot
    if snapshot is not None and model == ModelType.simulation \
            and cfg.require("simulation_multiple"):
        file_number = snapshot + (cfg.require("slow_offset")
                                  if bool(cfg.slow_light_on)
                                  else cfg.require("simulation_start"))
    path = format_filename(cfg.require("output_file"), file_number)
    # npy/raw need the packed (quantities, res, res) image block
    res = cfg.require("camera_resolution")
    packed = None
    from blacklight.constants import OutputFormat
    if cfg.require("output_format") != OutputFormat.npz:
        packed = np.asarray(image["I_nu"]).reshape(1, res, res) \
            if "I_nu" in image else None
        if "Q_nu" in image:
            packed = np.stack([
                np.asarray(image[k]).reshape(res, res)
                for k in ("I_nu", "Q_nu", "U_nu", "V_nu")])
    write_output(cfg, path, arrays, image_packed=packed)

    if not quiet:
        # Reference timing report (blacklight.cpp:259-269); geodesic,
        # sampling, and image integration are one fused device computation
        print("Calculation completed.")
        print(f"Elapsed time:                        {time.time() - t0:.6g} s")
        print(f"  Time reading simulation data:      {t_read:.6g} s")
        print(f"  Time integrating rays+sample+image: {t_image:.6g} s (fused)")
    return arrays
