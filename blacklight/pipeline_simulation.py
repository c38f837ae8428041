"""Simulation-model pipeline: GRMHD snapshot -> fused ray trace -> image.

Orchestrates the simulation path the reference spreads over
SimulationReader::Read (simulation_reader.cpp:200-861) and the
sampling/coefficient phases of RadiationIntegrator::Integrate
(radiation_integrator.cpp:676-762). Here the snapshot loads once to device
memory (replicated) and the sampler + synchrotron coefficients run inside
the same fused scan as the geodesic integration and RT accumulation.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from blacklight.constants import (
    ModelType,
    PlasmaModel,
    SimulationFormat,
)
from blacklight.camera import make_camera
from blacklight.grid.athena import load_athdf
from blacklight.grid.sampling import SamplerOptions, sample_grid
from blacklight.models import synchrotron
from blacklight.models.cuts import GeometricCuts, geometric_keep
from blacklight.output import format_filename
from blacklight.transfer.unpolarized import ImageOptions, integrate_unpolarized
from blacklight.utils.errors import BlacklightError


# Wavefront sampler shape constants (grid/wavefront.py): rays per dedup
# subtile, geodesic steps per window, and unique-cell table capacity.
# Measured on the production bench workload: a 1024-ray subtile touches
# <= ~800 unique cells per 128-step window, so 1024 slots leave headroom;
# overflow falls back to the exact per-step path.
WAVEFRONT_SUBTILE = 1024
WAVEFRONT_WINDOW = 128
WAVEFRONT_CAPACITY = 1024
# Window-table construction: "brick" (sort-free per-subtile dense bounding
# bricks, single-block grids) or "dedup" (sort + unique-rank, any grid).
# The brick variant replaces the dedup's sort with min-reductions and one
# contiguous slab fetch per subtile. Neither is measured on the H100 yet.
WAVEFRONT_MODE = "brick"
WAVEFRONT_BRICK = (8, 8, 16)  # (BK, BJ, BI) cells


def plasma_params_from_config(cfg) -> synchrotron.PlasmaParams:
    model = cfg.require("plasma_model")
    power_frac = cfg.require("plasma_power_frac")
    kappa_frac = cfg.require("plasma_kappa_frac")
    thermal_frac = 1.0 - power_frac - kappa_frac
    if thermal_frac < 0.0 or thermal_frac > 1.0:
        raise BlacklightError("Invalid plasma distribution fractions.")
    use_p = cfg.require("plasma_use_p") if model == PlasmaModel.ti_te_beta else True
    kwargs = {}
    if model == PlasmaModel.ti_te_beta and not use_p:
        kwargs = dict(gamma=cfg.require("plasma_gamma"),
                      gamma_i=cfg.require("plasma_gamma_i"),
                      gamma_e=cfg.require("plasma_gamma_e"))
    if power_frac != 0.0:
        kwargs.update(power_p=cfg.require("plasma_p"),
                      gamma_min=cfg.require("plasma_gamma_min"),
                      gamma_max=cfg.require("plasma_gamma_max"))
    if kappa_frac != 0.0:
        kwargs.update(kappa=cfg.require("plasma_kappa"),
                      w=cfg.require("plasma_w"))
    return synchrotron.PlasmaParams(
        mu=cfg.require("plasma_mu"),
        ne_ni=cfg.require("plasma_ne_ni"),
        model=model,
        use_p=use_p,
        rat_low=cfg.require("plasma_rat_low") if model == PlasmaModel.ti_te_beta else 1.0,
        rat_high=cfg.require("plasma_rat_high") if model == PlasmaModel.ti_te_beta else 1.0,
        power_frac=power_frac,
        kappa_frac=kappa_frac,
        **kwargs)


def cut_params_from_config(cfg) -> synchrotron.CutParams:
    return synchrotron.CutParams(
        rho_min=cfg.require("cut_rho_min"), rho_max=cfg.require("cut_rho_max"),
        n_e_min=cfg.require("cut_n_e_min"), n_e_max=cfg.require("cut_n_e_max"),
        p_gas_min=cfg.require("cut_p_gas_min"), p_gas_max=cfg.require("cut_p_gas_max"),
        theta_e_min=cfg.require("cut_theta_e_min"),
        theta_e_max=cfg.require("cut_theta_e_max"),
        b_min=cfg.require("cut_b_min"), b_max=cfg.require("cut_b_max"),
        sigma_min=cfg.require("cut_sigma_min"), sigma_max=cfg.require("cut_sigma_max"),
        beta_inverse_min=cfg.require("cut_beta_inverse_min"),
        beta_inverse_max=cfg.require("cut_beta_inverse_max"))


def load_grid_file(cfg, path: str, dtype=jnp.float64):
    """Load one snapshot file in the configured format."""
    fmt = cfg.require("simulation_format")
    kappa_name = None
    if cfg.require("plasma_model") == PlasmaModel.code_kappa:
        kappa_name = cfg.require("simulation_kappa_name")
    if fmt == SimulationFormat.athena:
        return load_athdf(path, kappa_name=kappa_name, dtype=dtype)
    if fmt == SimulationFormat.athenak:
        from blacklight.grid.athenak import load_athenak
        expected = {"a": cfg.require("simulation_a"),
                    "bhmass_msun": cfg.require("simulation_m_msun"),
                    "density_cgs": cfg.require("simulation_rho_cgs"),
                    "mu": cfg.require("plasma_mu")}
        return load_athenak(path, kappa_name=kappa_name, dtype=dtype,
                            plasma_gamma=cfg.plasma_gamma, expected=expected)
    if fmt == SimulationFormat.iharm3d:
        from blacklight.grid.iharm3d import load_iharm3d
        return load_iharm3d(path, cfg, dtype=dtype)
    from blacklight.grid.harm3d import load_harm3d
    return load_harm3d(path, cfg, dtype=dtype)


def load_grid(cfg, snapshot: Optional[int] = None, dtype=jnp.float64):
    """Load the snapshot (or slow-light window) for one output run.

    Returns (grid, snapshot_time); snapshot_time is 0 without slow light.
    """
    if cfg.require("simulation_multiple") and bool(cfg.slow_light_on):
        from blacklight.grid.slowlight import load_slow_window
        return load_slow_window(cfg, snapshot or 0, dtype=dtype)
    path = cfg.require("simulation_file")
    if cfg.require("simulation_multiple") and snapshot is not None:
        # Input files are numbered from simulation_start
        # (simulation_reader.cpp:305-307)
        path = format_filename(path, cfg.require("simulation_start") + snapshot)
    return load_grid_file(cfg, path, dtype=dtype), 0.0


def _sampler_options(cfg, snapshot_time: float = 0.0) -> SamplerOptions:
    return SamplerOptions(
        interp=cfg.require("simulation_interp"),
        block_interp=bool(cfg.simulation_block_interp),
        fallback_nan=cfg.require("fallback_nan"),
        fallback_rho=cfg.fallback_rho or 0.0,
        fallback_pgas=cfg.fallback_pgas or 0.0,
        fallback_kappa=cfg.fallback_kappa or 0.0,
        has_kappa=cfg.require("plasma_model") == PlasmaModel.code_kappa,
        snapshot_time=snapshot_time,
        slow_interp=bool(cfg.slow_interp) if bool(cfg.slow_light_on) else False)


def make_simulation_coeff_fns(cfg, grid, geom, frequencies, momentum_factors,
                              *, polarized: bool = False,
                              snapshot_time: float = 0.0):
    """Build (coeff_fn, cell_fn) closures for the fused transfer scans."""
    from blacklight.constants import Coordinates

    spin = cfg.require("simulation_a")
    sim_coords = "cks" if cfg.require("simulation_coord") == Coordinates.cks \
        else "sks"
    if grid.coords != sim_coords:
        raise BlacklightError(
            "simulation_coord does not match the loaded grid's coordinates.")
    rho_unit = cfg.require("simulation_rho_cgs")
    plasma = plasma_params_from_config(cfg)
    cuts_val = cut_params_from_config(cfg)
    cuts_geo = GeometricCuts.from_config(cfg)
    sampler_opts = _sampler_options(cfg, snapshot_time)
    nu0 = float(np.asarray(frequencies)[0])
    camera_x = geom.cam_x
    # Population constants are host-side scalars (Bessel/2F1 evaluations of
    # static plasma parameters); this function may be called under jit, so
    # force eager evaluation
    with jax.ensure_compile_time_eval():
        pl_consts = synchrotron.powerlaw_constants(plasma) \
            if plasma.power_frac != 0.0 else None
        kp_consts = synchrotron.kappa_constants(plasma, polarized=polarized) \
            if plasma.kappa_frac != 0.0 else None

    def state_at(pos, prims=None):
        samples = sample_grid(grid, pos, spin, sampler_opts) \
            if prims is None else dict(prims)
        keep_geo = geometric_keep(pos, spin, camera_x, cuts_geo)
        if polarized:
            # The reference's sampler never assigns values at geometrically
            # cut samples, leaving ZEROS that the polarized tetrad still
            # consumes (simulation_sampling.cpp:692-693 'continue' after
            # Zero()); mirror that.
            samples = {k: (jnp.where(keep_geo, v, 0.0)
                           if k not in ("off_grid", "nan_mask") else v)
                       for k, v in samples.items()}
        state = synchrotron.fluid_state(pos, samples, spin, plasma, rho_unit,
                                        coords=sim_coords)
        keep_val = synchrotron.value_cuts(state, cuts_val)
        b_zero = ((samples["bb1"] == 0.0) & (samples["bb2"] == 0.0)
                  & (samples["bb3"] == 0.0))
        nan_mask = samples.get("nan_mask")
        if nan_mask is None:
            nan_mask = jnp.zeros_like(keep_geo)
        return state, keep_geo, keep_val, b_zero, nan_mask

    def coeff_fn(pos, kcov, momentum_factors=momentum_factors, prims=None):
        state, keep_geo, keep_val, b_zero, nan_mask = state_at(pos, prims)
        sin_b, cos_b, sin2_b, u_dot_k = synchrotron.pitch_angle(
            pos, kcov, state, spin)
        nu_cgs = -u_dot_k[..., None] * frequencies[None, :] \
            * momentum_factors[..., None]
        coeffs = synchrotron.all_coefficients(
            nu_cgs, nu0, state, sin_b, cos_b, sin2_b, plasma, polarized,
            pl_consts=pl_consts, kp_consts=kp_consts)
        # Coupling skipped (-> zero coefficients) where cut or B = 0
        # (simulation_coefficients.cpp:257-262, 361-375, 393-394). Samples
        # the reference would NaN (fallback_nan off-grid) carry finite
        # placeholders plus the bad mask: the transfer NaN-poisons those
        # pixels, reproducing the reference's NaN propagation without NaN
        # primals in the differentiable graph.
        keep = (keep_geo & keep_val & ~b_zero)[..., None]
        out = {k: jnp.where(keep, v, 0.0) for k, v in coeffs.items()}
        # Geometric cuts happen BEFORE sampling in the reference
        # (simulation_sampling.cpp:237-295 'continue'), so only uncut
        # off-grid samples would carry its NaN values
        bad = jnp.broadcast_to((nan_mask & keep_geo)[..., None],
                               out["j_i"].shape)
        if polarized:
            out["ucon"] = state["ucon"]
            out["bcon"] = state["bcon"]
            out["b_zero"] = b_zero
            out["bad"] = bad
            return out
        return out["j_i"], out["alpha_i"], bad

    def cell_fn(pos, kcov, prims=None):
        state, keep_geo, keep_val, _, nan_mask = state_at(pos, prims)
        cells = synchrotron.cell_values(state)
        keep = (keep_geo & keep_val & ~nan_mask)[..., None]
        return jnp.where(keep, cells, jnp.nan)

    log_scale = synchrotron.log_j_scale(nu0)
    return coeff_fn, cell_fn, log_scale


def make_simulation_renderer(cfg, snapshot: Optional[int] = None,
                             early_exit: bool = True,
                             wavefront: bool = False,
                             wavefront_batch: bool = True):
    """Build a reusable simulation-model renderer.

    Returns (render_fn, geom, rays, frequencies, mass_msun) where
    render_fn(positions, directions, momentum_factors) renders any pixel
    bundle (root camera or adaptive child blocks) to a NumPy image dict.

    wavefront: allow the windowed deduplicated sampler (grid/wavefront.py)
    on eligible bundles. Values are bit-identical to the per-step sampler.
    Default OFF: it trades per-step gathers for window dedup/expansion
    work, which pays only where the gather floor dominates; its A/B on
    the H100 is not measured yet.

    wavefront_batch: evaluate the synchrotron coefficient chain over the
    whole window in one vmapped batch instead of per step (see
    transfer/unpolarized.integrate_unpolarized).
    """
    from blacklight import pipeline

    dtype = pipeline.compute_dtype(cfg)
    bh_m, bh_a, mass_msun = pipeline.bh_mass_spin(cfg)
    grid, snapshot_time = load_grid(cfg, snapshot=snapshot, dtype=dtype)
    use_block_interp = (bool(cfg.simulation_block_interp)
                        and cfg.require("simulation_interp"))
    if use_block_interp:
        from blacklight.grid.amr import with_amr_table
        grid = with_amr_table(grid)
    elif grid.times is None:
        # The packed-corner table is only consumed on the replicated,
        # non-slow-light, clamped-to-block sampling path
        # (grid/sampling.py use_packed); skip its 8x HBM footprint when
        # block interpolation or slow light routes around it.
        from blacklight.grid.athena import with_packed_corners
        grid = with_packed_corners(grid)
    geom, rays, frequencies = make_camera(cfg, bh_m=bh_m, bh_a=bh_a, dtype=dtype)
    params = pipeline.geodesic_params_from_config(cfg, bh_m, bh_a)
    opts = ImageOptions.from_config(cfg)
    slow = cfg.require("simulation_multiple") and bool(cfg.slow_light_on)
    if slow:
        import dataclasses
        opts = dataclasses.replace(opts, track_sample_times=True)
    polarized = bool(cfg.require("image_polarization")) if cfg.require("image_light") \
        else False
    any_image = (cfg.require("image_light") or opts.time or opts.length
                 or opts.lam or opts.emission or opts.tau or opts.lambda_ave
                 or opts.emission_ave or opts.tau_int or opts.crossings)

    def sample_stored(stored):
        """Sampled primitives at stored geodesic samples ((S, B) per var)
        for the sampling checkpoint."""
        spin = cfg.require("simulation_a")
        sampler_opts = _sampler_options(cfg)
        return jax.lax.map(
            lambda p: sample_grid(grid, p, spin, sampler_opts),
            stored[0].pos)

    # One jit per (stored-kind) variant: momentum factors and stored
    # samples are traced arguments so repeated pixel bundles of one shape
    # share the executable (tile dispatch would otherwise recompile)
    # The grid rides through jit as a pytree ARGUMENT (see
    # grid/athena.py pytree registration): closure capture would embed
    # the snapshot - up to GBs with the packed table - as HLO constants.
    # Wavefront eligibility (host-side, static): unpolarized scan path with
    # the packed-corner table and no slow-light time axis.
    wf_ok = (bool(wavefront) and not polarized and any_image
             and not use_block_interp and grid.times is None
             and grid.prim_packed is not None)

    @functools.lru_cache(maxsize=8)
    def fused_for(has_stored, has_prims, use_wf=False):
        def fused(positions, directions, momentum_factors, stored,
                  stored_prims, grid_arg):
            coeff_fn, cell_fn, log_scale = make_simulation_coeff_fns(
                cfg, grid_arg, geom, frequencies, momentum_factors,
                polarized=polarized, snapshot_time=snapshot_time)
            wf = None
            if use_wf:
                from blacklight.grid.wavefront import make_wavefront_prep
                n_sub = positions.shape[0] // WAVEFRONT_SUBTILE
                expand = "onehot" if grid_arg.prim_packed.dtype == \
                    jnp.float32 else "gather"
                mode = WAVEFRONT_MODE if grid_arg.prim.shape[1] == 1 \
                    else "dedup"
                prep_fn, prims_fn = make_wavefront_prep(
                    grid_arg, cfg.require("simulation_a"),
                    _sampler_options(cfg, snapshot_time), n_sub,
                    WAVEFRONT_CAPACITY, expand=expand, mode=mode,
                    brick=WAVEFRONT_BRICK)
                wf = (prep_fn, prims_fn, WAVEFRONT_WINDOW)
            image = {}
            if any_image:
                if polarized:
                    from blacklight.transfer.polarized import (
                        integrate_polarized)
                    need_cells = (opts.lambda_ave or opts.emission_ave
                                  or opts.tau_int)
                    image = integrate_polarized(
                        positions, directions, momentum_factors, frequencies,
                        params=params, coeff_fn=coeff_fn, opts=opts,
                        mass_msun=mass_msun, camera_x=geom.cam_x,
                        camera_u_con=geom.u_con, camera_u_cov=geom.u_cov,
                        camera_vert_con_c=geom.vert_con_c,
                        log_j_scale=log_scale,
                        rotation_split=bool(
                            cfg.require("image_rotation_split")),
                        stored=stored, stored_prims=stored_prims,
                        cell_fn=cell_fn if need_cells else None)
                else:
                    need_cells = (opts.lambda_ave or opts.emission_ave
                                  or opts.tau_int)
                    image = integrate_unpolarized(
                        positions, directions, momentum_factors, frequencies,
                        params=params, coeff_fn=coeff_fn, opts=opts,
                        mass_msun=mass_msun, camera_x=geom.cam_x,
                        cell_fn=cell_fn if need_cells else None,
                        early_exit=early_exit, log_j_scale=log_scale,
                        stored=stored, stored_prims=stored_prims,
                        wavefront=wf, wavefront_batch=wavefront_batch)

            if cfg.require("render_num_images") > 0:
                from blacklight.transfer.rendering import (
                    integrate_rendering)
                rgb, flags, n_samp = integrate_rendering(
                    positions, directions, params=params, cell_fn=cell_fn,
                    render_images=tuple(cfg.render_images),
                    mass_msun=mass_msun, stored=stored)
                image = dict(image)
                image["rendering"] = rgb
                image.setdefault("_flags", flags)
                image.setdefault("_n_samples", n_samp)
            return image

        if has_stored and has_prims:
            return jax.jit(fused)
        if has_stored:
            return jax.jit(lambda p, d, m, s, g: fused(p, d, m, s, None, g))
        return jax.jit(lambda p, d, m, g: fused(p, d, m, None, None, g))

    def _render_one(positions, directions, momentum_factors,
                    stored, stored_prims):
        if stored_prims is not None:
            return fused_for(True, True)(positions, directions,
                                         momentum_factors, stored,
                                         stored_prims, grid)
        if stored is not None:
            return fused_for(True, False)(positions, directions,
                                          momentum_factors, stored, grid)
        if wf_ok and positions.shape[0] % WAVEFRONT_SUBTILE == 0:
            image = fused_for(False, False, True)(
                positions, directions, momentum_factors, grid)
            if not np.asarray(image["_wavefront_overflow"]).any():
                image = dict(image)
                del image["_wavefront_overflow"]
                return image
            # Some window's unique-cell count exceeded the table capacity
            # (incoherent bundle); the slot-aliased values are wrong there,
            # so redo this bundle on the exact per-step path.
        return fused_for(False, False)(positions, directions,
                                       momentum_factors, grid)

    def render_fn(positions, directions, momentum_factors,
                  stored=None, stored_prims=None):
        # The polarized integrator streams samples (segmented geodesic
        # replay, transfer/polarized.py) just like the unpolarized scan,
        # so no pixel-axis chunking is needed at any bundle size.
        image = jax.tree.map(np.asarray, _render_one(
            positions, directions, momentum_factors, stored,
            stored_prims))
        if slow and "_t_min" in image:
            _check_time_extrapolation(image, grid, snapshot_time, snapshot)
        return image

    render_fn.sample_stored = sample_stored
    render_fn.geodesic_params = params
    render_fn.lower = lambda p, d, m: fused_for(False, False).lower(
        p, d, m, grid)
    return render_fn, geom, rays, frequencies, mass_msun


def _check_time_extrapolation(image, grid, snapshot_time, snapshot):
    """Reproduce the reference's slow-light extrapolation diagnostics
    (simulation_sampling.cpp:578-616): error when any pixel's samples
    extend beyond the time window by more than the tolerance, warn when
    within it."""
    from blacklight.grid.slowlight import EXTRAPOLATION_TOLERANCE as TOL

    times = np.asarray(grid.times)
    t_min = np.asarray(image["_t_min"]) + snapshot_time
    t_max = np.asarray(image["_t_max"]) + snapshot_time
    num_pix = t_min.shape[0]
    finite = np.isfinite(t_min)
    src_over = np.where(finite, times[-1] - t_min, 0.0)
    cam_over = np.where(np.isfinite(t_max), t_max - times[0], 0.0)
    n_src_large = int(np.sum(src_over > TOL))
    n_src_small = int(np.sum((src_over > 0.0) & (src_over <= TOL)))
    n_cam_large = int(np.sum(cam_over > TOL))
    n_cam_small = int(np.sum((cam_over > 0.0) & (cam_over <= TOL)))
    sn = 0 if snapshot is None else snapshot
    if n_cam_large:
        raise BlacklightError(
            f"Snapshot {sn} at time {snapshot_time} requires significant "
            f"extrapolation forward in time ({n_cam_large}/{num_pix} pixels, "
            f"by up to {np.max(cam_over):.6g} gravitational times).")
    if n_src_large:
        raise BlacklightError(
            f"Snapshot {sn} at time {snapshot_time} requires significant "
            f"extrapolation backward in time ({n_src_large}/{num_pix} "
            f"pixels, by up to {np.max(src_over):.6g} gravitational times).")
    from blacklight.utils.errors import blacklight_warning
    if n_cam_small:
        blacklight_warning(
            f"Snapshot {sn} at time {snapshot_time} requires moderate "
            f"extrapolation forward in time ({n_cam_small}/{num_pix} pixels, "
            f"by up to {np.max(cam_over):.6g} gravitational times).")
    if n_src_small:
        blacklight_warning(
            f"Snapshot {sn} at time {snapshot_time} requires moderate "
            f"extrapolation backward in time ({n_src_small}/{num_pix} "
            f"pixels, by up to {np.max(src_over):.6g} gravitational times).")


def render_simulation_image(cfg, snapshot: Optional[int] = None,
                            early_exit: bool = True):
    """Unpolarized (or polarized, if configured) simulation-model image.

    Returns (image_dict, camera_rays, frequencies, mass_msun).
    """
    render_fn, geom, rays, frequencies, mass_msun = make_simulation_renderer(
        cfg, snapshot=snapshot, early_exit=early_exit)
    image = render_fn(rays.positions, rays.directions, rays.momentum_factors)
    return image, rays, frequencies, mass_msun
