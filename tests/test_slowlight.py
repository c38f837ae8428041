"""Slow-light tests: sliding file window + per-sample time interpolation
(reference simulation_reader.cpp:211-303, simulation_sampling.cpp:297-349).
"""

import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "scripts"))
sys.path.insert(0, str(pathlib.Path(__file__).parent))

import generate_mock_simulation as gen  # noqa: E402

from blacklight import pipeline  # noqa: E402
from blacklight.utils.config import parse_config  # noqa: E402
from test_loaders import BASE_CONFIG  # noqa: E402


def write_series(d, times, amps):
    """Scale rho and pgas together so the electron temperature is fixed
    and brightness grows monotonically with amp."""
    p = dict(gen.DEFAULTS)
    for n, (t, amp) in enumerate(zip(times, amps)):
        pn = dict(p, time=t, rho_amp=p["rho_amp"] * amp,
                  pgas_amp=p["pgas_amp"] * amp)
        fields = gen.make_fields(pn)
        gen.write_athena(str(d / f"mock.{n:05d}.athdf"), fields, pn)


def slow_cfg(d, snapshot_template="mock.{5d}.athdf", **kv):
    cfg = parse_config(BASE_CONFIG.format(
        fmt="athena", path=str(d / snapshot_template), coord="sks",
        out=str(d / "out_{5d}.npz")))
    cfg.camera_resolution = 8
    cfg.simulation_multiple = True
    cfg.simulation_start = 0
    cfg.simulation_end = kv.get("end", 3)
    cfg.slow_light_on = True
    cfg.slow_interp = kv.get("interp", True)
    cfg.slow_chunk_size = kv.get("chunk", 2)
    cfg.slow_t_start = kv.get("t_start", 0.0)
    cfg.slow_dt = kv.get("dt", 100.0)
    cfg.slow_num_images = kv.get("num", 1)
    cfg.slow_offset = 0
    cfg.num_runs = cfg.slow_num_images
    return cfg


def static_cfg(d, filename, **kv):
    cfg = parse_config(BASE_CONFIG.format(
        fmt="athena", path=str(d / filename), coord="sks",
        out=str(d / "out_static.npz")))
    cfg.camera_resolution = 8
    return cfg


def test_slow_light_identical_files_match_static(tmp_path):
    """If every time slice holds identical data, slow light must reproduce
    the static render exactly (window + time interpolation are exercised
    but interpolate between equal values)."""
    write_series(tmp_path, times=[0.0, 200.0, 400.0, 600.0],
                 amps=[1.0, 1.0, 1.0, 1.0])
    static = pipeline.run(static_cfg(tmp_path, "mock.00000.athdf"),
                          quiet=True)
    slow = pipeline.run(slow_cfg(tmp_path, t_start=600.0, dt=0.0),
                        snapshot=0, quiet=True)
    np.testing.assert_allclose(slow["I_nu"], static["I_nu"], rtol=1e-12)


def test_slow_light_time_variation(tmp_path):
    """With density growing in time, later camera times see a brighter
    disk; nearest-slice and interpolated modes agree on the trend."""
    write_series(tmp_path, times=[0.0, 400.0, 800.0, 1200.0],
                 amps=[0.5, 1.0, 1.5, 2.0])
    img0 = pipeline.run(slow_cfg(tmp_path, t_start=500.0, dt=600.0, num=2,
                                 chunk=3),
                        snapshot=0, quiet=True)
    img1 = pipeline.run(slow_cfg(tmp_path, t_start=500.0, dt=600.0, num=2,
                                 chunk=3),
                        snapshot=1, quiet=True)
    f0 = np.nansum(img0["I_nu"])
    f1 = np.nansum(img1["I_nu"])
    assert f1 > f0 > 0.0

    nearest = pipeline.run(
        slow_cfg(tmp_path, t_start=500.0, dt=600.0, num=2, interp=False,
                 chunk=3),
        snapshot=1, quiet=True)
    fn = np.nansum(nearest["I_nu"])
    assert fn > f0
    # interpolated and nearest differ (time interpolation is active) but
    # agree to leading order
    assert not np.allclose(nearest["I_nu"], img1["I_nu"], rtol=1e-12)
    assert abs(fn - f1) < 0.5 * f1


def test_slow_light_insufficient_files_raises(tmp_path):
    from blacklight.utils.errors import BlacklightError
    write_series(tmp_path, times=[0.0, 200.0], amps=[1.0, 1.0])
    cfg = slow_cfg(tmp_path, end=1, chunk=2, t_start=5000.0, dt=0.0)
    with pytest.raises(BlacklightError):
        pipeline.run(cfg, snapshot=0, quiet=True)


def test_slow_light_extrapolation_error(tmp_path):
    """Samples extending beyond the oldest window slice by more than the
    tolerance raise, exactly like the reference
    (simulation_sampling.cpp:578-616): chunk 2 at snapshot time 500 only
    holds [400, 800] while rays look back ~120 gravitational times."""
    from blacklight.utils.errors import BlacklightError
    write_series(tmp_path, times=[0.0, 400.0, 800.0, 1200.0],
                 amps=[0.5, 1.0, 1.5, 2.0])
    with pytest.raises(BlacklightError, match="backward in time"):
        pipeline.run(slow_cfg(tmp_path, t_start=500.0, dt=600.0, num=2,
                              chunk=2),
                     snapshot=0, quiet=True)


def test_slow_light_amr_golden_vs_reference(tmp_path):
    """Slow light x interblock AMR interpolation: per-slice spatial
    interpolation through the cross-level neighbor table, then temporal
    lerp (simulation_sampling.cpp:923-1044 InterpolateAdvanced time
    branches). Series written by write_athena_amr with time-scaled
    rho/pgas.

    KNOWN REFERENCE DEVIATION: the reference's SampleSimulation reads the
    slow-light slice index with a 3-index accessor on the 4D
    corner-indexed array - `sample_inds(m,n,4)` at
    simulation_sampling.cpp:916 computes data[4 + 5*(n + 8*m)]
    (utils/array.cpp:317-325) while t_ind lives at (m,n,corner,4) =
    data[4 + 5*(corner + 8*(n + S*m))] - so its AMR time index belongs to
    a DIFFERENT (pixel, step). We implement the per-sample semantics the
    prep stores (:543-545). With slow_interp the (correctly read) t_frac
    limits the damage to the few samples whose misread slice differs:
    parity is exact (~1e-14) on 98% of pixels and within ~1% on the rest."""
    import pathlib
    fixtures = pathlib.Path(__file__).parent / "fixtures" / "slowamr"
    from blacklight import read_config
    cfg = read_config(str(fixtures / "golden_slowamr.input"))
    cfg.simulation_file = str(fixtures / "amr.{5d}.athdf")
    cfg.output_file = str(tmp_path / "slowamr_{d}.npz")
    for snap in (0, 1):
        ours = pipeline.run(cfg, snapshot=snap, quiet=True)
        ref = np.load(fixtures / f"golden_slowamr_{snap}.npz")
        scale = np.nanmax(np.abs(ref["I_nu"]))
        rel = np.abs(ours["I_nu"] - ref["I_nu"]) / (np.abs(ref["I_nu"])
                                                    + scale * 1e-8)
        assert np.array_equal(np.isnan(ours["I_nu"]), np.isnan(ref["I_nu"]))
        frac_exact = np.mean(np.nan_to_num(rel) < 1e-8)
        assert frac_exact > 0.97, (snap, frac_exact)
        assert np.nanmax(rel) < 0.05, (snap, np.nanmax(rel))


def test_slow_light_amr_identical_slices_match_static(tmp_path):
    """With identical time slices, slow light x AMR (nearest AND
    interpolated) must reproduce the static interblock render exactly -
    pins our (correct, per-sample) time indexing against the static
    sampler the reference golden validates at 1e-8."""
    import pathlib
    import shutil
    fixtures = pathlib.Path(__file__).parent / "fixtures"
    import h5py
    times = [0.0, 400.0, 800.0, 1200.0]
    for n, t in enumerate(times):
        dst = tmp_path / f"amr.{n:05d}.athdf"
        shutil.copy(fixtures / "slowamr" / "amr.00001.athdf", dst)
        with h5py.File(dst, "r+") as f:
            f.attrs.modify("Time", np.float32(t))

    from blacklight import read_config
    base = read_config(str(fixtures / "slowamr" / "golden_slowamr.input"))
    base.simulation_file = str(tmp_path / "amr.{5d}.athdf")
    base.output_file = str(tmp_path / "slow_{d}.npz")
    images = {}
    for interp in (True, False):
        base.slow_interp = interp
        images[interp] = pipeline.run(base, snapshot=0, quiet=True)

    static = read_config(str(fixtures / "slowamr" / "golden_slowamr.input"))
    static.simulation_file = str(tmp_path / "amr.00000.athdf")
    static.simulation_multiple = False
    static.slow_light_on = False
    static.output_file = str(tmp_path / "static.npz")
    img_s = pipeline.run(static, quiet=True)
    for interp in (True, False):
        np.testing.assert_allclose(images[interp]["I_nu"], img_s["I_nu"],
                                   rtol=1e-12)


def test_slow_light_golden_vs_reference(tmp_path):
    """Slow-light window + per-sample linear time interpolation match the
    compiled reference binary on a stored time-varying snapshot series
    (fixtures/slowlight; series built with the reference's own mock
    generator, Time attributes and densities patched per slice)."""
    import pathlib
    fixtures = pathlib.Path(__file__).parent / "fixtures" / "slowlight"
    from blacklight import read_config
    cfg = read_config(str(fixtures / "golden_slow.input"))
    cfg.simulation_file = str(fixtures / "small.{5d}.athdf")
    cfg.output_file = str(tmp_path / "slow_{d}.npz")
    for snap in (0, 1):
        ours = pipeline.run(cfg, snapshot=snap, quiet=True)
        ref = np.load(fixtures / f"golden_slow_{snap}.npz")
        scale = np.nanmax(np.abs(ref["I_nu"]))
        rel = np.abs(ours["I_nu"] - ref["I_nu"]) / (np.abs(ref["I_nu"])
                                                    + scale * 1e-8)
        assert np.array_equal(np.isnan(ours["I_nu"]), np.isnan(ref["I_nu"]))
        assert np.nanmax(rel) < 1e-7, (snap, np.nanmax(rel))
