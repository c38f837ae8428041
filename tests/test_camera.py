"""Camera tests: pixel positions against reference golden output, null momenta."""

import jax.numpy as jnp
import numpy as np
import pytest

from blacklight import read_config
from blacklight.camera import make_camera
from blacklight.ops import geometry


@pytest.fixture(scope="module")
def formula_cfg(fixtures_dir):
    return read_config(str(fixtures_dir / "golden_formula_cam_32.input"))


def test_pixel_positions_match_reference(fixtures_dir, formula_cfg):
    """Camera pixel events must match the reference's saved 'positions' array."""
    golden = np.load(fixtures_dir / "golden_formula_cam_32.npz")
    ref_pos = golden["positions"].reshape(-1, 4)
    spin = formula_cfg.require("formula_spin")
    _, rays, _ = make_camera(formula_cfg, bh_m=1.0, bh_a=spin)
    np.testing.assert_allclose(np.asarray(rays.positions), ref_pos, rtol=1e-12, atol=1e-12)


def test_pixel_momenta_null(formula_cfg):
    """Every pixel's covariant momentum satisfies g^{munu} p_mu p_nu = 0."""
    spin = formula_cfg.require("formula_spin")
    _, rays, _ = make_camera(formula_cfg, bh_m=1.0, bh_a=spin)
    g_con = geometry.gcon(rays.positions[:, 1:], spin)
    norm = jnp.einsum("...ij,...i,...j->...", g_con, rays.directions, rays.directions)
    # Normalize by p_0^2 for scale
    np.testing.assert_allclose(norm / rays.directions[:, 0] ** 2, 0.0, atol=1e-10)


def test_momentum_factor_normalization(formula_cfg):
    """factor * (-p.u) = 1 for camera normalization (camera.cpp:576-583)."""
    spin = formula_cfg.require("formula_spin")
    geom, rays, _ = make_camera(formula_cfg, bh_m=1.0, bh_a=spin)
    nu_local = -jnp.einsum("ni,i->n", rays.directions, geom.u_con)
    np.testing.assert_allclose(rays.momentum_factors * nu_local, 1.0, rtol=1e-12)


def test_frequency_tables():
    from blacklight.camera import image_frequency_table
    from blacklight.constants import FrequencySpacing
    f = image_frequency_table(1, 2.3e11)
    np.testing.assert_allclose(f, [2.3e11])
    f = image_frequency_table(3, 0.0, 1e10, 1e12, FrequencySpacing.lin_freq)
    np.testing.assert_allclose(f, [1e10, 5.05e11, 1e12])
    f = image_frequency_table(3, 0.0, 1e10, 1e12, FrequencySpacing.log)
    np.testing.assert_allclose(f, [1e10, 1e11, 1e12])
    f = image_frequency_table(3, 0.0, 1e10, 1e12, FrequencySpacing.lin_wave)
    np.testing.assert_allclose(f, [1e10, 1.0 / (0.5 * (1e-10 + 1e-12)), 1e12])
