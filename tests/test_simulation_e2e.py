"""End-to-end simulation-model tests against reference goldens (mock athdf)."""

import numpy as np
import pytest

from blacklight import read_config
from blacklight.pipeline_simulation import render_simulation_image


def render(fixtures_dir, name, **overrides):
    cfg = read_config(str(fixtures_dir / name))
    cfg.simulation_file = str(fixtures_dir / "mock_small.athdf")
    for k, v in overrides.items():
        setattr(cfg, k, v)
    image, rays, freqs, mass = render_simulation_image(cfg)
    return cfg, image


def test_simulation_rk4_exact_parity(fixtures_dir):
    """Thermal-synchrotron image from the mock GRMHD snapshot matches the
    reference rk4 run at float64 accumulation level: validates the athdf
    loader, CKS->SKS conversion, cell search, trilinear sampling, fluid-state
    construction, pitch angle, thermal emissivity/Kirchhoff absorption, and
    the value cuts in one shot."""
    cfg, image = render(fixtures_dir, "golden_sim_rk4_32.input")
    I = image["I_nu"][:, 0].reshape(32, 32)
    gold = np.load(fixtures_dir / "golden_sim_rk4_32.npz")["I_nu"]
    np.testing.assert_allclose(I, gold, rtol=1e-8)


def test_simulation_dp_quadrature_parity(fixtures_dir):
    cfg, image = render(fixtures_dir, "golden_sim_32.input")
    I = image["I_nu"][:, 0].reshape(32, 32)
    gold = np.load(fixtures_dir / "golden_sim_32.npz")["I_nu"]
    rel = np.abs(I - gold) / (np.abs(gold) + gold.max() * 1e-8)
    assert np.nanmax(rel) < 6e-2
    assert np.nanmean(rel) < 5e-3


def test_gradient_wrt_grid_density(fixtures_dir):
    """New capability: pixels are differentiable with respect to the GRMHD
    density field. Scaling rho scales n_e (linear in j) but also shifts
    theta_e/sigma/beta - check against finite differences."""
    import dataclasses
    import functools
    import jax
    import jax.numpy as jnp

    from blacklight import pipeline
    from blacklight.camera import make_camera
    from blacklight.constants import RayIntegrator
    from blacklight.pipeline_simulation import (
        load_grid, make_simulation_coeff_fns)
    from blacklight.transfer.unpolarized import (
        ImageOptions, integrate_unpolarized)

    cfg = read_config(str(fixtures_dir / "golden_sim_rk4_32.input"))
    cfg.simulation_file = str(fixtures_dir / "mock_small.athdf")
    cfg.camera_resolution = 4
    cfg.ray_max_steps = 600

    bh_m, bh_a, mass_msun = pipeline.bh_mass_spin(cfg)
    grid0, _ = load_grid(cfg)
    geom, rays, freqs = make_camera(cfg, bh_m=bh_m, bh_a=bh_a)
    params = pipeline.geodesic_params_from_config(cfg, bh_m, bh_a)

    def total_flux(scale):
        grid = dataclasses.replace(
            grid0, prim=grid0.prim.at[grid0.ind["rho"]].multiply(scale))
        coeff_fn, cell_fn, log_scale = make_simulation_coeff_fns(
            cfg, grid, geom, freqs, rays.momentum_factors)
        img = integrate_unpolarized(
            rays.positions, rays.directions, rays.momentum_factors, freqs,
            params=params, coeff_fn=coeff_fn, opts=ImageOptions(),
            mass_msun=mass_msun, camera_x=geom.cam_x, log_j_scale=log_scale)
        return jnp.nansum(img["I_nu"])

    g = jax.grad(total_flux)(1.0)
    # The sampler's float32 round-trip (parity with the reference's float
    # storage) quantizes small perturbations, so the FD probe needs a large
    # step and a loose tolerance.
    eps = 1e-3
    fd = (total_flux(1.0 + eps) - total_flux(1.0 - eps)) / (2 * eps)
    assert np.isfinite(g)
    np.testing.assert_allclose(g, fd, rtol=1e-2)


def test_powerlaw_rk4_exact_parity(fixtures_dir):
    """Power-law electron population (M 38-42)."""
    cfg, image = render(fixtures_dir, "golden_plasma_pow_rk4_32.input")
    I = image["I_nu"][:, 0].reshape(32, 32)
    gold = np.load(fixtures_dir / "golden_plasma_pow_rk4_32.npz")["I_nu"]
    np.testing.assert_allclose(I, gold, rtol=1e-8)


def test_kappa_rk4_exact_parity(fixtures_dir):
    """Kappa electron population (M 43-54), including the reproduced
    reference quirk that unpolarized runs get zero kappa absorption
    (kappa_aa_high_i only initialized under image_polarization)."""
    cfg, image = render(fixtures_dir, "golden_plasma_kap_rk4_32.input")
    I = image["I_nu"][:, 0].reshape(32, 32)
    gold = np.load(fixtures_dir / "golden_plasma_kap_rk4_32.npz")["I_nu"]
    np.testing.assert_allclose(I, gold, rtol=1e-8)


def test_plasma_mix_polarized_parity(fixtures_dir):
    """Thermal+power-law+kappa mixture through the polarized transfer."""
    cfg = read_config(str(fixtures_dir / "golden_plasma_mix_pol_rk4_32.input"))
    cfg.simulation_file = str(fixtures_dir / "mock_small.athdf")
    image, rays, freqs, mass = render_simulation_image(cfg)
    gold = np.load(fixtures_dir / "golden_plasma_mix_pol_rk4_32.npz")
    iscale = np.nanmax(np.abs(gold["I_nu"]))
    for k, tol in (("I_nu", 1e-7), ("Q_nu", 1e-3), ("U_nu", 1e-3), ("V_nu", 1e-3)):
        ours = image[k][:, 0].reshape(32, 32)
        rel = np.abs(ours - gold[k]) / (np.abs(gold[k]) + iscale * 1e-8)
        assert np.nanmax(rel) < tol, f"{k}: {np.nanmax(rel)}"


def test_thermal_tau_parity(fixtures_dir):
    cfg, image = render(fixtures_dir, "golden_sim_rk4_32.input", image_tau=True)
    gold = np.load(fixtures_dir / "golden_sim_tau_rk4_32.npz")["tau"]
    ours = image["tau"][:, 0].reshape(32, 32)
    np.testing.assert_allclose(ours, gold, rtol=1e-8)
