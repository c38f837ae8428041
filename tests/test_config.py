"""Tests for the input-file configuration parser."""

import math

import pytest

from blacklight.constants import ModelType, RayIntegrator, RenderType
from blacklight.utils.config import parse_config
from blacklight.utils.errors import BlacklightError


def test_basic_parse():
    cfg = parse_config(
        """
        model_type = formula   # comment
        camera_resolution = 64
        ray_step = 0.01
        image_light = true
        """
    )
    assert cfg.model_type is ModelType.formula
    assert cfg.camera_resolution == 64
    assert cfg.ray_step == 0.01
    assert cfg.image_light is True
    assert cfg.num_runs == 1


def test_degrees_and_pole():
    cfg = parse_config("camera_th = 60.0\ncamera_ph = 90.0\ncamera_rotation = 45.0")
    assert math.isclose(cfg.camera_th, math.pi / 3)
    assert math.isclose(cfg.camera_ph, math.pi / 2)
    assert math.isclose(cfg.camera_rotation, math.pi / 4)
    assert cfg.camera_pole is False
    cfg2 = parse_config("camera_th = 180.0")
    assert cfg2.camera_pole is True
    assert math.isclose(cfg2.camera_th, math.pi)


def test_triple():
    cfg = parse_config("cut_plane_origin = 1.0, 2.0, -3.0")
    assert (cfg.cut_plane_origin_x, cfg.cut_plane_origin_y, cfg.cut_plane_origin_z) == (
        1.0, 2.0, -3.0)


def test_bad_bool():
    with pytest.raises(BlacklightError):
        parse_config("image_light = yes")


def test_unknown_key():
    with pytest.raises(BlacklightError):
        parse_config("no_such_key = 1")


def test_render_keys():
    cfg = parse_config(
        """
        render_num_images = 1
        render_1_num_features = 2
        render_1_1_quantity = rho
        render_1_1_type = fill
        render_1_1_min = 1.0e-3
        render_1_1_max = inf
        render_1_1_tau_scale = 10.0
        render_1_1_xyz = 0.5, 0.3, 0.2
        render_1_2_quantity = sigma
        render_1_2_type = thresh
        render_1_2_thresh = 1.0
        render_1_2_opacity = 0.8
        render_1_2_rgb = 255, 0, 0
        """
    )
    assert cfg.render_num_images == 1
    img = cfg.render_images[0]
    assert img.num_features == 2
    assert img.features[0].quantity == 0
    assert img.features[0].render_type is RenderType.fill
    assert img.features[0].max_val == float("inf")
    assert img.features[0].x_val == 0.5
    assert img.features[1].render_type is RenderType.thresh
    # Pure red: linearized sRGB (1,0,0) through the matrix
    assert math.isclose(img.features[1].x_val, 0.4123955889674142, rel_tol=1e-12)


def test_adaptive_regions():
    cfg = parse_config(
        """
        adaptive_num_regions = 2
        adaptive_region_1_level = 2
        adaptive_region_1_x_min = -5.0
        adaptive_region_1_x_max = 5.0
        adaptive_region_1_y_min = -1.0
        adaptive_region_1_y_max = 1.0
        adaptive_region_2_level = 1
        """
    )
    assert cfg.adaptive_num_regions == 2
    assert cfg.adaptive_regions[0].level == 2
    assert cfg.adaptive_regions[0].x_max == 5.0
    assert cfg.adaptive_regions[1].level == 1


def test_num_runs_multiple():
    cfg = parse_config(
        """
        model_type = simulation
        simulation_multiple = true
        slow_light_on = false
        simulation_start = 10
        simulation_end = 14
        """
    )
    assert cfg.num_runs == 5


def test_require():
    cfg = parse_config("model_type = formula")
    assert cfg.require("model_type") is ModelType.formula
    with pytest.raises(BlacklightError):
        cfg.require("camera_r")


def test_reference_examples_parse():
    import pathlib
    ref_inputs = pathlib.Path("/root/reference/input")
    if not ref_inputs.exists():
        pytest.skip("reference inputs not available")
    from blacklight.utils.config import read_config
    for p in sorted(ref_inputs.glob("*.input")):
        cfg = read_config(str(p))
        assert cfg.model_type is not None
