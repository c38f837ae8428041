"""False-color rendering and multi-frequency (true color) tests."""

import numpy as np

from blacklight import read_config
from blacklight.pipeline_simulation import render_simulation_image


def render(fixtures_dir, name):
    cfg = read_config(str(fixtures_dir / name))
    cfg.simulation_file = str(fixtures_dir / "mock_small.athdf")
    image, rays, freqs, mass = render_simulation_image(cfg)
    return cfg, image


def test_rendering_rk4_exact_parity(fixtures_dir):
    """fill (optical-depth color accumulation) + thresh (opacity blending)
    false-color rendering matches the reference bit-for-allclose."""
    cfg, image = render(fixtures_dir, "golden_render_rk4_32.input")
    gold = np.load(fixtures_dir / "golden_render_rk4_32.npz")["rendering"]
    ours = np.transpose(image["rendering"], (1, 2, 0)).reshape(gold.shape)
    np.testing.assert_allclose(ours, gold, rtol=1e-8,
                               atol=np.abs(gold).max() * 1e-10)


def test_rendering_dp_quadrature_parity(fixtures_dir):
    """Threshold crossings are binary events sensitive to sample placement;
    with the dp integrator agreement is statistical."""
    cfg, image = render(fixtures_dir, "golden_render_32.input")
    gold = np.load(fixtures_dir / "golden_render_32.npz")["rendering"]
    ours = np.transpose(image["rendering"], (1, 2, 0)).reshape(gold.shape)
    err = np.abs(ours - gold) / (np.abs(gold).max())
    assert np.nanmean(err) < 5e-3
    assert np.nanmax(err) < 2e-1


def test_true_color_rk4_exact_parity(fixtures_dir):
    """10-frequency lin-wave image (true color input) matches the reference."""
    cfg, image = render(fixtures_dir, "golden_true_color_rk4_32.input")
    gold = np.load(fixtures_dir / "golden_true_color_rk4_32.npz")["I_nu"]
    ours = np.moveaxis(image["I_nu"].reshape(32, 32, 10), -1, 0)
    np.testing.assert_allclose(ours, gold, rtol=1e-8)


def test_true_color_npz_output(fixtures_dir, tmp_path):
    """End-to-end npz write path for multi-frequency images."""
    from blacklight import pipeline
    cfg = read_config(str(fixtures_dir / "golden_true_color_rk4_32.input"))
    cfg.simulation_file = str(fixtures_dir / "mock_small.athdf")
    cfg.output_file = str(tmp_path / "tc.npz")
    pipeline.run(cfg, quiet=True)
    data = np.load(tmp_path / "tc.npz")
    gold = np.load(fixtures_dir / "golden_true_color_rk4_32.npz")
    assert data["I_nu"].shape == (10, 32, 32)
    np.testing.assert_allclose(data["I_nu"], gold["I_nu"], rtol=1e-8)
    np.testing.assert_allclose(data["frequency"], gold["frequency"])
