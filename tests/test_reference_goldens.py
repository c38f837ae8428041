"""Adaptive refinement golden test against the reference binary.

The golden npz was produced by the compiled reference (blacklight) on the
deterministic mock torus written by scripts/generate_mock_simulation.py
with default parameters (see BASELINE.md regeneration protocol); the mock
is regenerated here rather than stored.
"""

import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "scripts"))

import generate_mock_simulation as gen  # noqa: E402

from blacklight import read_config, pipeline  # noqa: E402


def test_adaptive_golden_parity(fixtures_dir, tmp_path):
    p = dict(gen.DEFAULTS)
    fields = gen.make_fields(p)
    gen.write_athena(str(tmp_path / "mock.athdf"), fields, p)

    cfg = read_config(str(fixtures_dir / "golden_adaptive_32.input"))
    cfg.simulation_file = str(tmp_path / "mock.athdf")
    cfg.output_file = str(tmp_path / "out.npz")
    ours = pipeline.run(cfg, quiet=True)
    ref = np.load(fixtures_dir / "golden_adaptive_32.npz")

    np.testing.assert_array_equal(ours["adaptive_num_levels"],
                                  ref["adaptive_num_levels"])
    np.testing.assert_array_equal(ours["adaptive_num_blocks"],
                                  ref["adaptive_num_blocks"])
    scale = np.nanmax(np.abs(ref["I_nu"]))
    rel = np.abs(ours["I_nu"] - ref["I_nu"]) / (np.abs(ref["I_nu"])
                                                + scale * 1e-8)
    assert np.nanmax(rel) < 1e-8

    # Same refined blocks (order-independent), same per-block images
    o_map = {tuple(v): i for i, v in enumerate(ours["adaptive_block_locs_1"])}
    r_map = {tuple(v): i for i, v in enumerate(ref["adaptive_block_locs_1"])}
    assert set(o_map) == set(r_map)
    for loc, oi in o_map.items():
        a = ours["adaptive_I_nu_1"][oi]
        b = ref["adaptive_I_nu_1"][r_map[loc]]
        rel = np.abs(a - b) / (np.abs(b) + scale * 1e-8)
        assert np.nanmax(rel) < 1e-8, loc


def test_pinhole_golden_parity(fixtures_dir, tmp_path):
    """Pinhole-camera simulation render matches the reference binary
    (SetPixelPinhole, camera.cpp:608-671)."""
    p = dict(gen.DEFAULTS)
    fields = gen.make_fields(p)
    gen.write_athena(str(tmp_path / "mock.athdf"), fields, p)
    cfg = read_config(str(fixtures_dir / "golden_pinhole_32.input"))
    cfg.simulation_file = str(tmp_path / "mock.athdf")
    cfg.output_file = str(tmp_path / "out.npz")
    ours = pipeline.run(cfg, quiet=True)
    ref = np.load(fixtures_dir / "golden_pinhole_32.npz")
    scale = np.nanmax(np.abs(ref["I_nu"]))
    rel = np.abs(ours["I_nu"] - ref["I_nu"]) / (np.abs(ref["I_nu"])
                                                + scale * 1e-8)
    assert np.array_equal(np.isnan(ours["I_nu"]), np.isnan(ref["I_nu"]))
    assert np.nanmax(rel) < 1e-8


def test_code_kappa_golden_parity(fixtures_dir, tmp_path):
    """code_kappa electron-entropy temperature model matches the reference
    binary (simulation_coefficients.cpp:351-358)."""
    p = dict(gen.DEFAULTS)
    fields = gen.make_fields(p)
    gen.write_athena(str(tmp_path / "mock.athdf"), fields, p, kappa=True)
    cfg = read_config(str(fixtures_dir / "golden_code_kappa_32.input"))
    cfg.simulation_file = str(tmp_path / "mock.athdf")
    cfg.output_file = str(tmp_path / "out.npz")
    ours = pipeline.run(cfg, quiet=True)
    ref = np.load(fixtures_dir / "golden_code_kappa_32.npz")
    scale = np.nanmax(np.abs(ref["I_nu"]))
    rel = np.abs(ours["I_nu"] - ref["I_nu"]) / (np.abs(ref["I_nu"])
                                                + scale * 1e-8)
    assert np.array_equal(np.isnan(ours["I_nu"]), np.isnan(ref["I_nu"]))
    assert np.nanmax(rel) < 1e-8
