"""Checkpoint save/load tests (reference geodesic_checkpoint.cpp:28-108,
sample_checkpoint.cpp:22-63)."""

import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "scripts"))

from blacklight import pipeline  # noqa: E402
from blacklight.utils.config import parse_config  # noqa: E402
from blacklight.utils.errors import BlacklightError  # noqa: E402


def formula_cfg(tmp_path, **kv):
    text = f"""
model_type = formula
output_format = npz
output_file   = {tmp_path}/out.npz
output_camera = false
checkpoint_geodesic_save = {str(kv.get('save', False)).lower()}
checkpoint_geodesic_load = {str(kv.get('load', False)).lower()}
checkpoint_geodesic_file = {tmp_path}/geo.npz
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
camera_resolution = 8
ray_flat        = false
ray_terminate   = additive
ray_factor      = 5.0e-4
ray_integrator  = rk4
ray_step        = 0.01
ray_max_steps   = 1600
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
    return parse_config(text)


def test_geodesic_checkpoint_roundtrip(tmp_path):
    """Save run == load run == plain run; load must not re-integrate."""
    base = pipeline.run(formula_cfg(tmp_path), quiet=True)
    saved = pipeline.run(formula_cfg(tmp_path, save=True), quiet=True)
    assert (tmp_path / "geo.npz").exists()
    loaded = pipeline.run(formula_cfg(tmp_path, load=True), quiet=True)
    np.testing.assert_allclose(saved["I_nu"], base["I_nu"], rtol=1e-12)
    np.testing.assert_allclose(loaded["I_nu"], saved["I_nu"], rtol=0, atol=0)


def test_geodesic_checkpoint_mutual_exclusion(tmp_path):
    cfg = formula_cfg(tmp_path, save=True, load=True)
    with pytest.raises(BlacklightError):
        pipeline.run(cfg, quiet=True)


@pytest.fixture(scope="module")
def mock_grid_file(tmp_path_factory):
    import generate_mock_simulation as gen
    d = tmp_path_factory.mktemp("ckpt_mock")
    p = dict(gen.DEFAULTS)
    fields = gen.make_fields(p)
    path = str(d / "mock.athdf")
    gen.write_athena(path, fields, p)
    return path


def sim_cfg(tmp_path, grid_path, **kv):
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from test_loaders import BASE_CONFIG
    cfg = parse_config(BASE_CONFIG.format(
        fmt="athena", path=grid_path, coord="sks",
        out=str(tmp_path / "out.npz")))
    cfg.camera_resolution = 8
    cfg.checkpoint_sample_save = kv.get("save", False)
    cfg.checkpoint_sample_load = kv.get("load", False)
    cfg.checkpoint_sample_file = str(tmp_path / "samp.npz")
    return cfg


def test_sample_checkpoint_roundtrip(tmp_path, mock_grid_file):
    base = pipeline.run(sim_cfg(tmp_path, mock_grid_file), quiet=True)
    saved = pipeline.run(sim_cfg(tmp_path, mock_grid_file, save=True),
                         quiet=True)
    assert (tmp_path / "samp.npz").exists()
    loaded = pipeline.run(sim_cfg(tmp_path, mock_grid_file, load=True),
                          quiet=True)
    np.testing.assert_allclose(saved["I_nu"], base["I_nu"], rtol=1e-12)
    np.testing.assert_allclose(loaded["I_nu"], saved["I_nu"], rtol=0, atol=0)
