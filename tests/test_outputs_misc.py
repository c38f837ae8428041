"""Output formats, output_camera, pinhole camera, deeper adaptive levels."""

import numpy as np
import pytest

from blacklight import pipeline
from blacklight.utils.config import parse_config
from blacklight.utils.errors import BlacklightError

from test_adaptive import CONFIG, make_cfg


def test_npy_output(tmp_path):
    cfg = make_cfg(tmp_path, res=8, max_level=0)
    cfg.output_file = str(tmp_path / "out.npy")
    from blacklight.constants import OutputFormat
    cfg.output_format = OutputFormat.npy
    arrays = pipeline.run(cfg, quiet=True)
    packed = np.load(tmp_path / "out.npy")
    assert packed.shape == (1, 8, 8)
    np.testing.assert_array_equal(packed[0], arrays["I_nu"])


def test_raw_output(tmp_path):
    cfg = make_cfg(tmp_path, res=8, max_level=0)
    cfg.output_file = str(tmp_path / "out.raw")
    from blacklight.constants import OutputFormat
    cfg.output_format = OutputFormat.raw
    arrays = pipeline.run(cfg, quiet=True)
    raw = np.fromfile(tmp_path / "out.raw", dtype=np.float64)
    np.testing.assert_array_equal(raw.reshape(8, 8), arrays["I_nu"])


def test_raw_rejects_adaptive(tmp_path):
    cfg = make_cfg(tmp_path, res=16, max_level=1)
    from blacklight.constants import OutputFormat
    cfg.output_format = OutputFormat.raw
    with pytest.raises(BlacklightError):
        pipeline.run(cfg, quiet=True)


def test_output_camera_positions(tmp_path):
    cfg = make_cfg(tmp_path, res=8, max_level=0)
    cfg.output_camera = True
    arrays = pipeline.run(cfg, quiet=True)
    assert arrays["positions"].shape == (8, 8, 4)
    # Pixel events sit near the camera plane (|x| ~ camera_r)
    r = np.linalg.norm(arrays["positions"][..., 1:], axis=-1)
    assert np.all(np.abs(r - 100.0) < 20.0)


def test_pinhole_camera_renders(tmp_path):
    cfg = make_cfg(tmp_path, res=8, max_level=0)
    from blacklight.constants import CameraType
    cfg.camera_type = CameraType.pinhole
    cfg.output_camera = True
    arrays = pipeline.run(cfg, quiet=True)
    I = arrays["I_nu"]
    assert np.isfinite(I).all() and np.nanmax(I) > 0.0
    # Pinhole saves directions; all rays originate at one point
    assert arrays["directions"].shape == (8, 8, 4)


def test_adaptive_two_levels(tmp_path):
    """max_level=2: level-2 blocks are children of refined level-1 blocks
    and match a direct 4x-resolution render."""
    cfg = make_cfg(tmp_path, res=16, max_level=2)
    arrays = pipeline.run(cfg, quiet=True)
    assert arrays["adaptive_num_levels"][0] == 2
    locs2 = arrays["adaptive_block_locs_2"]
    locs1 = {tuple(v) for v in arrays["adaptive_block_locs_1"]}
    parents = {(v // 2, u // 2) for v, u in locs2}
    assert parents <= locs1

    cfg64 = make_cfg(tmp_path, res=64, max_level=0)
    full = pipeline.run(cfg64, quiet=True)["I_nu"]
    I2 = arrays["adaptive_I_nu_2"]
    for b in range(min(4, locs2.shape[0])):
        v, u = locs2[b]
        np.testing.assert_allclose(
            I2[b], full[v * 8:(v + 1) * 8, u * 8:(u + 1) * 8], rtol=1e-10)


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "checkout"])
def test_compilation_cache_placement(tmp_path, monkeypatch, env_set):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache and
    nothing else; without it, a fixed directory inside the checkout, the
    same on every call (the path is part of each entry's key)."""
    import os
    import pathlib

    import jax

    from blacklight.utils import cache

    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
        expected = str(tmp_path / "xla")
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        expected = str(pathlib.Path(__file__).resolve().parent.parent
                       / ".jax_cache")
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        used = cache.enable_compilation_cache()
        assert used == expected
        assert os.path.isdir(used)
        assert jax.config.jax_compilation_cache_dir == expected
        assert cache.enable_compilation_cache() == expected
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
