"""Adaptive image-plane refinement tests (formula model, fast).

Semantics anchored to the reference: block criteria radiation_adaptive.cpp
:163-312, child spawning camera.cpp:426-504, per-level npz arrays
numpy_format.cpp:291-527.
"""

import numpy as np
import pytest

from blacklight import adaptive as ad
from blacklight.utils.config import parse_config


CONFIG = """
model_type = formula
output_format = npz
output_file   = {out}
output_camera = false
checkpoint_geodesic_save = false
checkpoint_geodesic_load = false
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
camera_resolution = {res}
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
adaptive_max_level      = {max_level}
adaptive_block_size     = 8
adaptive_frequency_num  = 1
adaptive_val_cut        = 5.0e-6
adaptive_val_frac       = 0.0
adaptive_abs_grad_cut   = 0.0
adaptive_abs_grad_frac  = -1.0
adaptive_rel_grad_cut   = 0.0
adaptive_rel_grad_frac  = -1.0
adaptive_abs_lapl_cut   = 0.0
adaptive_abs_lapl_frac  = -1.0
adaptive_rel_lapl_cut   = 1.0
adaptive_rel_lapl_frac  = -1.0
adaptive_num_regions    = {num_regions}
{regions}
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


def make_cfg(tmp_path, res=32, max_level=1, num_regions=0, regions=""):
    return parse_config(CONFIG.format(out=str(tmp_path / "out.npz"), res=res,
                                      max_level=max_level,
                                      num_regions=num_regions,
                                      regions=regions))


def test_evaluate_blocks_value_criterion():
    p = ad.AdaptiveParams(max_level=1, block_size=4, val_cut=1.0, val_frac=0.5)
    blocks = np.zeros((3, 4, 4))
    blocks[1] = 2.0                # all exceed -> refine
    blocks[2, :2] = 2.0            # half exceed -> 0.5 not > 0.5 -> keep
    flags = ad.evaluate_blocks(blocks, p)
    assert flags.tolist() == [False, True, False]


def test_evaluate_blocks_nan_excluded():
    p = ad.AdaptiveParams(max_level=1, block_size=4, val_cut=1.0, val_frac=0.4)
    blocks = np.full((1, 4, 4), np.nan)
    blocks[0, 0, :2] = 2.0  # 2 exceed out of 2 finite -> frac 1.0 -> refine
    assert ad.evaluate_blocks(blocks, p).tolist() == [True]


def test_child_block_locs_order():
    locs = np.array([[0, 0], [0, 1], [1, 1]], dtype=np.int32)
    flags = np.array([True, False, True])
    children = ad.child_block_locs(locs, flags)
    # camera.cpp:455-460: v outer, u inner
    np.testing.assert_array_equal(children, [
        [0, 0], [0, 1], [1, 0], [1, 1],
        [2, 2], [2, 3], [3, 2], [3, 3]])


def test_root_block_extraction_matches_locs():
    res, bs = 8, 4
    img = np.arange(64, dtype=float)
    locs = ad.root_block_locs(res, bs)
    blocks = ad.extract_root_blocks(img, res, bs)
    full = img.reshape(8, 8)
    for b in range(blocks.shape[0]):
        v, u = locs[b]
        np.testing.assert_array_equal(
            blocks[b], full[v * bs:(v + 1) * bs, u * bs:(u + 1) * bs])


def test_adaptive_run_refines_and_matches_direct_render(tmp_path):
    """Level-1 adaptive pixels must equal the same pixels of a straight
    double-resolution render: child blocks carry the exact fractional
    pixel coordinates of the finer grid (camera.cpp:465-499)."""
    from blacklight import pipeline

    cfg = make_cfg(tmp_path, res=32, max_level=1)
    arrays = pipeline.run(cfg, quiet=True)
    assert arrays["adaptive_num_levels"][0] == 1
    n_blocks = arrays["adaptive_num_blocks"][1]
    assert n_blocks > 0 and n_blocks % 4 == 0
    locs = arrays["adaptive_block_locs_1"]
    I1 = arrays["adaptive_I_nu_1"]          # (blocks, 8, 8)
    assert I1.shape == (n_blocks, 8, 8)

    cfg64 = make_cfg(tmp_path, res=64, max_level=0)
    arrays64 = pipeline.run(cfg64, quiet=True)
    full = arrays64["I_nu"]
    for b in range(n_blocks):
        v, u = locs[b]
        np.testing.assert_allclose(
            I1[b], full[v * 8:(v + 1) * 8, u * 8:(u + 1) * 8],
            rtol=1e-10, err_msg=f"block {b} at ({v},{u})")


def test_forced_region_refinement(tmp_path):
    """A forced region refines its blocks even when criteria would not
    (radiation_adaptive.cpp:51-69)."""
    regions = """
adaptive_region_1_level = 1
adaptive_region_1_x_min = -6.0
adaptive_region_1_x_max = 6.0
adaptive_region_1_y_min = -6.0
adaptive_region_1_y_max = 6.0
"""
    from blacklight import pipeline

    cfg = make_cfg(tmp_path, res=32, max_level=1, num_regions=1,
                   regions=regions)
    # Disable all criteria: only the forced region drives refinement
    cfg.adaptive_val_frac = -1.0
    arrays = pipeline.run(cfg, quiet=True)
    assert arrays["adaptive_num_levels"][0] == 1
    locs = arrays["adaptive_block_locs_1"]
    # Parent blocks with centers in [-6,6]^2 at width 25, 4x4 root blocks:
    # block centers at (±3.125, ±9.375); the 4 central parents qualify
    assert arrays["adaptive_num_blocks"][1] == 16
    assert locs.min() >= 2 and locs.max() <= 5
