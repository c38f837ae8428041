"""Postprocessing script tests: calculate_flux, join_outputs, plotting."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

SCRIPTS = pathlib.Path(__file__).parent.parent / "scripts"
sys.path.insert(0, str(SCRIPTS))
sys.path.insert(0, str(pathlib.Path(__file__).parent))

from test_adaptive import make_cfg  # noqa: E402

from blacklight import pipeline  # noqa: E402


REGION = """
adaptive_region_1_level = 1
adaptive_region_1_x_min = {x_min}
adaptive_region_1_x_max = {x_max}
adaptive_region_1_y_min = -10.0
adaptive_region_1_y_max = 10.0
"""


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """One plain and two adaptive (different forced regions) formula runs."""
    d = tmp_path_factory.mktemp("outputs")
    plain = pipeline.run(make_cfg(d, res=16, max_level=0), quiet=True)

    def adaptive_run(tag, x_min, x_max):
        cfg = make_cfg(d, res=16, max_level=1, num_regions=1,
                       regions=REGION.format(x_min=x_min, x_max=x_max))
        cfg.adaptive_val_frac = -1.0  # forced regions only
        cfg.output_file = str(d / f"out_{tag}.npz")
        return pipeline.run(cfg, quiet=True)

    left = adaptive_run("left", -10.0, 0.0)
    right = adaptive_run("right", 0.0, 10.0)
    return {"dir": d, "plain": plain, "left": left, "right": right}


def test_calculate_flux_adaptive_matches_plain(outputs):
    from calculate_flux import flux_jy
    f_plain = flux_jy(outputs["plain"], distance_pc=5.07e9)
    f_left = flux_jy(outputs["left"], distance_pc=5.07e9)
    assert f_plain > 0.0
    # Refinement re-renders part of the smooth image at 2x resolution:
    # flux changes only at discretization level
    assert abs(f_left - f_plain) < 0.02 * f_plain


def test_calculate_flux_matches_reference_algorithm():
    """Pin adaptive flux on the reference-binary golden output.

    The expected value was computed by running the reference's own
    block-masking algorithm (scripts/calculate_flux.py:155-209, with its
    py2-era integer divisions fixed) on the same npz; our flux_jy must
    reproduce it exactly (same nanmean-per-block accumulation order).
    """
    from calculate_flux import flux_jy
    fixture = pathlib.Path(__file__).parent / "fixtures" / "golden_adaptive_32.npz"
    with np.load(fixture) as f:
        data = {k: f[k] for k in f.files}
    assert flux_jy(data, distance_pc=5.07e9) == pytest.approx(
        1.0689442032207076e-12, rel=1e-14)


def test_join_outputs_union(outputs):
    from join_outputs import join
    d = outputs["dir"]
    merged = join([str(d / "out_left.npz"), str(d / "out_right.npz")])
    n_l = outputs["left"]["adaptive_num_blocks"][1]
    n_r = outputs["right"]["adaptive_num_blocks"][1]
    n_m = merged["adaptive_num_blocks"][1]
    locs_l = {tuple(v) for v in outputs["left"]["adaptive_block_locs_1"]}
    locs_r = {tuple(v) for v in outputs["right"]["adaptive_block_locs_1"]}
    locs_m = {tuple(v) for v in merged["adaptive_block_locs_1"]}
    assert locs_m == locs_l | locs_r
    assert n_m == len(locs_l | locs_r) and n_m <= n_l + n_r
    assert merged[f"adaptive_I_nu_1"].shape[0] == n_m


def test_plot_scripts_produce_files(outputs, tmp_path):
    d = outputs["dir"]
    for script, src, dst in (
            ("plot_image.py", d / "out_left.npz", tmp_path / "img.png"),):
        proc = subprocess.run(
            [sys.executable, str(SCRIPTS / script), str(src), str(dst)],
            capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr
        assert dst.exists() and dst.stat().st_size > 0


def test_true_color_rgb_shape():
    from plot_true_color import true_color_rgb
    freqs = np.linspace(1e11, 5e11, 6)
    imgs = np.random.default_rng(0).random((6, 8, 8))
    rgb = true_color_rgb(freqs, imgs)
    assert rgb.shape == (8, 8, 3)
    assert np.all((rgb >= 0.0) & (rgb <= 1.0))


def test_xyz_to_srgb_primaries():
    from plot_render import xyz_to_srgb
    # D65 white point maps to neutral white
    white = xyz_to_srgb(np.array([0.9505, 1.0, 1.089]))
    assert np.all(np.abs(white - 1.0) < 2e-2)
    black = xyz_to_srgb(np.zeros(3))
    assert np.all(black == 0.0)
