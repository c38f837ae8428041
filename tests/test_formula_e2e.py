"""End-to-end formula-model tests against reference golden outputs."""

import numpy as np
import pytest

from blacklight import read_config
from blacklight import pipeline


def render(fixtures_dir, name, **overrides):
    cfg = read_config(str(fixtures_dir / name))
    for k, v in overrides.items():
        setattr(cfg, k, v)
    image, rays, freqs, mass = pipeline.render_formula_image(cfg)
    return cfg, image


def test_formula_rk4_exact_parity(fixtures_dir):
    """Our rk4 integrator reproduces the reference rk4 image to float64
    accumulation accuracy."""
    cfg, image = render(fixtures_dir, "golden_formula_cam_rk4_32.input")
    I = image["I_nu"][:, 0].reshape(32, 32)
    gold = np.load(fixtures_dir / "golden_formula_cam_rk4_32.npz")["I_nu"]
    np.testing.assert_allclose(I, gold, rtol=1e-7)


def test_formula_dp_quadrature_parity(fixtures_dir):
    """Our dp (capped-step, no dense-output subdivision) agrees with the
    reference dp image at quadrature-convergence level."""
    cfg, image = render(fixtures_dir, "golden_formula_32.input")
    I = image["I_nu"][:, 0].reshape(32, 32)
    gold = np.load(fixtures_dir / "golden_formula_32.npz")["I_nu"]
    rel = np.abs(I - gold) / (np.abs(gold) + gold.max() * 1e-8)
    assert np.nanmax(rel) < 5e-3
    assert np.nanmean(rel) < 1e-3


def test_formula_aux_images(fixtures_dir):
    """Auxiliary image planes (time/length/lambda/emission/tau/crossings)
    match the reference within quadrature tolerance."""
    cfg, image = render(fixtures_dir, "golden_formula_aux_32.input")
    gold = np.load(fixtures_dir / "golden_formula_aux_32.npz")
    res = 32
    checks = {
        "time": 2e-2,
        "length": 2e-2,
        "lambda": 2e-2,
        "emission": 1e-2,
        "crossings": 0.0,  # exact integer counts
    }
    for name, tol in checks.items():
        ours = np.asarray(image[name])
        if ours.ndim == 2:
            ours = ours[:, 0]
        ours = ours.reshape(res, res)
        g = gold[name]
        if name == "crossings":
            # integer counts; allow a handful of pixels to differ by 1 where
            # a crossing lands within one sample spacing of a path endpoint
            frac_diff = np.mean(ours != g)
            assert frac_diff < 0.02, f"crossings differ on {frac_diff:.1%} of pixels"
            continue
        denom = np.abs(g) + np.nanmax(np.abs(g)) * 1e-8
        rel = np.abs(ours - g) / denom
        assert np.nanmax(rel) < tol, f"{name}: max rel {np.nanmax(rel)}"
    # tau is identically zero here (formula_a = 0): exact match expected
    ours_tau = np.asarray(image["tau"])[:, 0].reshape(res, res)
    np.testing.assert_allclose(ours_tau, gold["tau"], atol=1e-300)


def test_cli_writes_npz(fixtures_dir, tmp_path):
    """CLI end-to-end: parses input, renders, writes reference-named npz."""
    import subprocess
    import sys
    src = (fixtures_dir / "golden_formula_32.input").read_text()
    src = src.replace("output/golden_formula_32.npz", str(tmp_path / "out.npz"))
    inp = tmp_path / "test.input"
    inp.write_text(src)
    env = {"JAX_PLATFORMS": "cpu", "PYTHONPATH": "/root/repo",
           "PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": "/root"}
    result = subprocess.run([sys.executable, "-m", "blacklight", str(inp)],
                            capture_output=True, text=True, env=env, timeout=600)
    assert result.returncode == 0, result.stderr
    data = np.load(tmp_path / "out.npz")
    assert set(data.files) >= {"mass_msun", "width", "frequency",
                               "adaptive_num_levels", "I_nu"}
    gold = np.load(fixtures_dir / "golden_formula_32.npz")
    rel = np.abs(data["I_nu"] - gold["I_nu"]) / (np.abs(gold["I_nu"])
                                                 + gold["I_nu"].max() * 1e-8)
    assert np.nanmax(rel) < 5e-3
    np.testing.assert_allclose(data["mass_msun"], gold["mass_msun"])
    np.testing.assert_allclose(data["width"], gold["width"])
    np.testing.assert_allclose(data["frequency"], gold["frequency"])


def test_gradients_wrt_emission_params(fixtures_dir):
    """New capability: d(image)/d(formula params) via jax.grad matches FD."""
    import jax
    import jax.numpy as jnp
    from blacklight.camera import make_camera
    from blacklight.models import formula as formula_model
    from blacklight.transfer.unpolarized import ImageOptions, integrate_unpolarized

    cfg = read_config(str(fixtures_dir / "golden_formula_32.input"))
    cfg.camera_resolution = 4
    # Enough steps for every ray to terminate: flagged rays NaN-poison
    # their pixels (fallback_nan), and an all-NaN image makes this test
    # vacuous (it silently passed as NaN == NaN before the flagged-ray
    # gradient sanitization).
    cfg.ray_max_steps = 2600
    spin = cfg.require("formula_spin")
    geom, rays, freqs = make_camera(cfg, bh_m=1.0, bh_a=spin)
    params = pipeline.geodesic_params_from_config(cfg, 1.0, spin)
    from blacklight.constants import RayIntegrator
    import dataclasses
    params = dataclasses.replace(params, integrator=RayIntegrator.rk4)
    fparams = formula_model.formula_params_from_config(cfg)
    _, _, mass_msun = pipeline.bh_mass_spin(cfg)

    def total_flux(cn0):
        fp = dataclasses.replace(fparams, cn0=cn0)

        def coeff_fn(pos, kcov):
            j, a, _, bad = formula_model.formula_coefficients(
                pos, kcov, rays.momentum_factors, freqs, fp, geom.cam_x)
            return j, a, bad

        img = integrate_unpolarized(
            rays.positions, rays.directions, rays.momentum_factors, freqs,
            params=params, coeff_fn=coeff_fn, opts=ImageOptions(),
            mass_msun=mass_msun, camera_x=geom.cam_x,
            log_j_scale=formula_model.formula_log_j_scale(fp))
        return jnp.nansum(img["I_nu"])

    c0 = cfg.require("formula_cn0")
    g = jax.grad(total_flux)(c0)
    flux = total_flux(c0)
    assert np.isfinite(flux) and flux > 0.0
    # Linear in cn0 (formula_a = 0, no absorption): grad * cn0 == flux
    np.testing.assert_allclose(g * c0, flux, rtol=1e-10)


def test_formula_rk2_exact_parity(fixtures_dir):
    """The rk2 (Heun) integrator reproduces the reference rk2 image to
    float64 accumulation accuracy (geodesics.cpp:626-795 semantics:
    half-step sample, fixed h)."""
    cfg, image = render(fixtures_dir, "golden_formula_rk2_32.input")
    I = image["I_nu"][:, 0].reshape(32, 32)
    gold = np.load(fixtures_dir / "golden_formula_rk2_32.npz")["I_nu"]
    np.testing.assert_allclose(I, gold, rtol=1e-7)
