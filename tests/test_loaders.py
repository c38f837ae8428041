"""Cross-format snapshot loader tests.

The mock generator (scripts/generate_mock_simulation.py) writes the same
analytic a=0 torus in all supported formats; every loader must reconstruct
the identical physical snapshot (reference readers: simulation_reader.cpp
:200-861), and ray-traced images must agree across formats.
"""

import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "scripts"))

import generate_mock_simulation as gen  # noqa: E402

from blacklight import read_config  # noqa: E402
from blacklight.grid.athena import load_athdf  # noqa: E402
from blacklight.grid.athenak import load_athenak  # noqa: E402
from blacklight.grid.harm3d import load_harm3d  # noqa: E402
from blacklight.grid.iharm3d import load_iharm3d  # noqa: E402


BASE_CONFIG = """
model_type  = simulation
output_format = npz
output_file   = {out}
output_camera = false
checkpoint_geodesic_save = false
checkpoint_geodesic_load = false
checkpoint_sample_save   = false
checkpoint_sample_load   = false
simulation_format       = {fmt}
simulation_file         = {path}
simulation_multiple     = false
simulation_coord        = {coord}
simulation_a            = 0.0
simulation_m_msun       = 4.152e6
simulation_rho_cgs      = 1.0e-16
simulation_interp       = true
simulation_block_interp = false
camera_type       = plane
camera_r          = 50.0
camera_th         = 45.0
camera_ph         = 0.0
camera_urn        = 0.0
camera_uthn       = 0.0
camera_uphn       = 0.0
camera_k_r        = 1.0
camera_k_th       = 0.0
camera_k_ph       = 0.0
camera_rotation   = 0.0
camera_width      = 24.0
camera_resolution = 16
ray_flat        = false
ray_terminate   = multiplicative
ray_factor      = 1.005
ray_integrator  = rk4
ray_step        = 0.01
ray_max_steps   = 1200
image_light           = true
image_num_frequencies = 1
image_frequency       = 2.3e11
image_normalization   = infinity
image_polarization    = false
render_num_images = 0
slow_light_on = false
adaptive_max_level = 0
plasma_mu         = 0.5
plasma_ne_ni      = 1.0
plasma_model      = ti_te_beta
plasma_use_p      = true
plasma_rat_low    = 1.0
plasma_rat_high   = 10.0
plasma_power_frac = 0.0
plasma_kappa_frac = 0.0
cut_rho_min = -1.0
cut_rho_max = -1.0
cut_n_e_min = -1.0
cut_n_e_max = -1.0
cut_p_gas_min = -1.0
cut_p_gas_max = -1.0
cut_theta_e_min = -1.0
cut_theta_e_max = -1.0
cut_b_min = -1.0
cut_b_max = -1.0
cut_sigma_min = -1.0
cut_sigma_max = 1.0
cut_beta_inverse_min = -1.0
cut_beta_inverse_max = -1.0
cut_omit_near = false
cut_omit_far  = false
cut_omit_in   = -1.0
# Keep every format sampling the same physical region: the torus lives in
# r in [4, 20]; the AthenaK Cartesian cube only covers the inscribed
# r < 21.2 sphere while spherical grids cover r < 30.
cut_omit_out  = 20.5
cut_midplane_theta = 0.0
cut_midplane_z = 0.0
cut_plane = false
fallback_nan  = false
fallback_rho  = 1.0e-8
fallback_pgas = 1.0e-10
"""


@pytest.fixture(scope="module")
def mock_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mocks")
    p = dict(gen.DEFAULTS)
    fields = gen.make_fields(p)
    paths = {}
    gen.write_athena(str(d / "mock.athdf"), fields, p)
    gen.write_iharm3d(str(d / "mock_iharm.h5"), fields, p)
    gen.write_iharm3d_fmks(str(d / "mock_fmks.h5"), fields, p)
    gen.write_harm3d(str(d / "mock.harm"), fields, p)
    gen.write_athenak(str(d / "mock.bin"), fields, p)
    paths["athena"] = str(d / "mock.athdf")
    paths["iharm3d"] = str(d / "mock_iharm.h5")
    paths["fmks"] = str(d / "mock_fmks.h5")
    paths["harm3d"] = str(d / "mock.harm")
    paths["athenak"] = str(d / "mock.bin")
    paths["dir"] = str(d)
    return paths


def make_cfg(paths, fmt, key, coord="sks", **overrides):
    text = BASE_CONFIG.format(fmt=fmt, path=paths[key],
                              coord=coord, out=paths["dir"] + "/out.npz")
    from blacklight.utils.config import parse_config
    cfg = parse_config(text)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def render(paths, fmt, key, coord="sks", **overrides):
    from blacklight.pipeline_simulation import render_simulation_image
    cfg = make_cfg(paths, fmt, key, coord, **overrides)
    image, rays, freqs, mass = render_simulation_image(cfg)
    return image["I_nu"][:, 0].reshape(16, 16)


def test_cross_format_prim_parity(mock_files):
    """iharm3d and harm3d loaders reconstruct the identical snapshot the
    athdf loader reads (float32 storage precision)."""
    cfg = make_cfg(mock_files, "iharm3d", "iharm3d")
    g_a = load_athdf(mock_files["athena"])
    g_i = load_iharm3d(mock_files["iharm3d"], cfg)
    g_h = load_harm3d(mock_files["harm3d"], cfg)
    pa = np.asarray(g_a.prim)
    for g in (g_i, g_h):
        pg = np.asarray(g.prim)
        for name in ("rho", "pgas", "uu1", "uu2", "uu3",
                     "bb1", "bb2", "bb3"):
            a = pa[g_a.ind[name]]
            b = pg[g.ind[name]]
            # Normal-frame components recovered through the coordinate
            # frame carry float32 cancellation noise relative to the
            # intermediate (coordinate-frame) magnitude, not the final one.
            scale = max(np.max(np.abs(a)), 0.5)
            np.testing.assert_allclose(b, a, atol=5e-7 * scale,
                                       err_msg=name)
    np.testing.assert_allclose(np.asarray(g_i.x1v), np.asarray(g_a.x1v),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g_h.x2v), np.asarray(g_a.x2v),
                               rtol=1e-6, atol=1e-9)


def test_fmks_map_roundtrip():
    """SKS->FMKS inverse table composed with the forward theta formula is
    the identity to table resolution."""
    from blacklight.grid import mks
    p = mks.FmksParams(h=0.3, r_in=2.0, poly_xt=0.82, poly_alpha=14.0,
                       mks_smooth=0.5)
    table, dr, dth = mks.generate_sks_map(p, 2.0, 30.0, n1=256, n2=256)
    th_target = np.minimum(dth * np.arange(256), np.pi)
    r_back, th_back = mks.fmks_sks_coords(table[0], table[1], p)
    np.testing.assert_allclose(r_back, np.broadcast_to(
        2.0 + dr * np.arange(256)[None, :], (256, 256)), rtol=1e-12)
    np.testing.assert_allclose(th_back,
                               np.broadcast_to(th_target[:, None], (256, 256)),
                               atol=1e-9)


def test_image_iharm3d_matches_athena(mock_files):
    """Same snapshot, same grid -> near-identical images."""
    I_a = render(mock_files, "athena", "athena")
    I_i = render(mock_files, "iharm3d", "iharm3d")
    scale = np.nanmax(I_a)
    np.testing.assert_allclose(I_i, I_a, atol=1e-5 * scale)


def test_image_harm3d_matches_athena(mock_files):
    I_a = render(mock_files, "athena", "athena")
    I_h = render(mock_files, "harm3d", "harm3d")
    scale = np.nanmax(I_a)
    np.testing.assert_allclose(I_h, I_a, atol=1e-5 * scale)


def test_image_fmks_matches_athena_grid_aligned(tmp_path):
    """With mks_smooth=0 the FMKS theta map is x1-independent, so an athdf
    file can carry the IDENTICAL collocation points. Nearest sampling then
    selects identical cells in both and the images match to float32
    storage precision. (Trilinear weights legitimately differ - FMKS
    interpolates in native x^2, the reference does the same,
    simulation_sampling.cpp:412-424 - so interp mode is not exact.)"""
    from blacklight.grid import mks as mksmod

    p = dict(gen.DEFAULTS)
    params = mksmod.FmksParams(h=0.3, r_in=p["r_min"], poly_xt=0.82,
                               poly_alpha=14.0, mks_smooth=0.0)
    x2f = np.linspace(0.0, 1.0, p["n_th"] + 1)
    x2v = 0.5 * (x2f[:-1] + x2f[1:])
    _, thf = mksmod.fmks_sks_coords(np.zeros_like(x2f), x2f, params)
    _, thv = mksmod.fmks_sks_coords(np.zeros_like(x2v), x2v, params)
    fields = gen.make_fields(p, thf=thf, thv=thv)
    gen.write_athena(str(tmp_path / "m.athdf"), fields, p)
    gen.write_iharm3d_fmks(str(tmp_path / "f.h5"), fields, p,
                           hslope=0.3, mks_smooth=0.0)
    paths = {"athena": str(tmp_path / "m.athdf"),
             "fmks": str(tmp_path / "f.h5"), "dir": str(tmp_path)}
    I_a = render(paths, "athena", "athena", simulation_interp=False)
    I_f = render(paths, "iharm3d", "fmks", coord="fmks",
                 simulation_interp=False)
    scale = np.nanmax(I_a)
    np.testing.assert_allclose(I_f, I_a, atol=2e-5 * scale)


def test_image_fmks_smooth_matches_athena_loosely(mock_files):
    """mks_smooth>0 FMKS grid samples the same physical torus on different
    theta collocation points; at this coarse grid the images agree only to
    discretization accuracy (difference halves when the grid is doubled -
    verified out-of-band)."""
    I_a = render(mock_files, "athena", "athena")
    I_f = render(mock_files, "iharm3d", "fmks", coord="fmks")
    scale = np.nanmax(I_a)
    assert np.nanmax(np.abs(I_f - I_a)) < 0.4 * scale
    assert abs(np.nansum(I_f) - np.nansum(I_a)) < 0.1 * np.nansum(I_a)


def test_multiblock_and_block_interp(tmp_path):
    """Multi-block grids: block search reproduces the single-block image
    away from boundaries, and simulation_block_interp interpolates across
    block faces (FindNearbyInds/InterpolateAdvanced analog,
    simulation_sampling.cpp:1068-1386). Splitting along phi keeps cell
    sizes equal across the boundary, so cross-block interpolation must
    reproduce the single-block trilinear almost exactly."""
    p = dict(gen.DEFAULTS)
    fields = gen.make_fields(p)
    gen.write_athena(str(tmp_path / "one.athdf"), fields, p)
    gen.write_athena(str(tmp_path / "four.athdf"), fields, p, phi_blocks=4)
    paths = {"one": str(tmp_path / "one.athdf"),
             "four": str(tmp_path / "four.athdf"), "dir": str(tmp_path)}
    I_one = render(paths, "athena", "one")
    I_multi = render(paths, "athena", "four")
    I_interp = render(paths, "athena", "four", simulation_block_interp=True)
    scale = np.nanmax(I_one)
    # Without block interp, edge cells extrapolate: small boundary error
    assert np.nanmax(np.abs(I_multi - I_one)) < 0.05 * scale
    # With block interp the split grid must match the unsplit one tightly
    np.testing.assert_allclose(I_interp, I_one, atol=2e-5 * scale)


def test_code_kappa_plasma_model(tmp_path):
    """code_kappa electron-temperature model (simulation_coefficients.cpp:
    351-358) end-to-end: an athdf with an electron-entropy slice renders a
    finite, positive image."""
    p = dict(gen.DEFAULTS)
    fields = gen.make_fields(p)
    gen.write_athena(str(tmp_path / "mk.athdf"), fields, p, kappa=True)
    paths = {"athena": str(tmp_path / "mk.athdf"), "dir": str(tmp_path)}
    cfg = make_cfg(paths, "athena", "athena")
    cfg.plasma_model = __import__(
        "blacklight.constants", fromlist=["PlasmaModel"]
    ).PlasmaModel.code_kappa
    cfg.simulation_kappa_name = "kappa"
    from blacklight.pipeline_simulation import render_simulation_image
    image, *_ = render_simulation_image(cfg)
    I = image["I_nu"][:, 0]
    assert np.isfinite(I).all()
    assert np.nanmax(I) > 0.0


def test_image_athenak_matches_athena(mock_files):
    """Cartesian AthenaK grid of the same torus -> images agree to
    (coarser) discretization accuracy."""
    I_a = render(mock_files, "athena", "athena")
    I_k = render(mock_files, "athenak", "athenak", coord="cks")
    scale = np.nanmax(I_a)
    assert np.nanmax(np.abs(I_k - I_a)) < 0.25 * scale
    assert abs(np.nansum(I_k) - np.nansum(I_a)) < 0.08 * np.nansum(I_a)


@pytest.mark.parametrize("loader", ["athena", "iharm3d"])
def test_hdf5_loaders_name_missing_h5py(monkeypatch, fixtures_dir, loader):
    """Without h5py the HDF5 loaders raise a BlacklightError that names
    it, not a bare ImportError."""
    from blacklight.utils.errors import BlacklightError

    monkeypatch.setitem(sys.modules, "h5py", None)
    path = str(fixtures_dir / "mock_small.athdf")
    with pytest.raises(BlacklightError, match="h5py"):
        if loader == "athena":
            load_athdf(path)
        else:
            load_iharm3d(path, None)
