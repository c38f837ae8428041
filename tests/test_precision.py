"""float32 on the render path: contraction precision and agreement with
float64.

XLA:GPU runs float32 dot_general in TF32 unless told otherwise, which no
CPU golden can catch, so every contraction the renderers lower must carry
HIGHEST precision. The float32 renders themselves are held to float64 with
the gate chip_smoke.py applies on the card (blacklight/utils/compare.py).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blacklight import pipeline, read_config
from blacklight.ops import geodesic
from blacklight.utils.compare import FLOAT32_FLUX_TOL, image_agreement

GOLDEN_FORMULA = {
    "dp": "golden_formula_32.input",
    "rk4": "golden_formula_cam_rk4_32.input",
    "rk2": "golden_formula_rk2_32.input",
}
RES = 16


def _formula_cfg(fixtures_dir, name, precision):
    cfg = read_config(str(fixtures_dir / name))
    cfg.camera_resolution = RES
    cfg.precision = precision
    return cfg


@pytest.mark.parametrize("integrator", sorted(GOLDEN_FORMULA))
def test_float32_formula_matches_float64(fixtures_dir, integrator):
    """The float32 transfer run over the float64 render's own geodesics
    (the geodesic-checkpoint path) passes the full statistical gate, and
    the whole float32 render agrees with float64 on NaN sets and total
    flux (FLOAT32_FLUX_TOL says why no per-pixel bound holds there)."""
    name = GOLDEN_FORMULA[integrator]
    cfg64 = _formula_cfg(fixtures_dir, name, "float64")
    cfg32 = _formula_cfg(fixtures_dir, name, "float32")
    render64, _, rays64, _, _ = pipeline.make_formula_renderer(cfg64)
    render32, _, rays32, _, _ = pipeline.make_formula_renderer(cfg32)
    ref = render64(rays64.positions, rays64.directions,
                   rays64.momentum_factors)["I_nu"]
    full32 = render32(rays32.positions, rays32.directions,
                      rays32.momentum_factors)["I_nu"]
    assert full32.dtype == np.float32
    whole = image_agreement(full32, ref)
    assert whole["nan_match"], whole
    assert whole["flux_rel"] < FLOAT32_FLUX_TOL, whole

    samples, flags, n = jax.jit(lambda p, d: geodesic.trace_geodesics(
        p, d, render64.geodesic_params))(rays64.positions,
                                         rays64.directions)
    samples32 = jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, samples)
    transfer32 = render32(rays32.positions, rays32.directions,
                          rays32.momentum_factors,
                          stored=(samples32, flags, n))["I_nu"]
    gate = image_agreement(transfer32, ref)
    assert gate["ok"], gate


def _lowered_render(fixtures_dir, kind):
    if kind == "formula":
        cfg = read_config(str(fixtures_dir / "golden_formula_32.input"))
        cfg.camera_resolution = 4
        cfg.precision = "float32"
        render, _, rays, _, _ = pipeline.make_formula_renderer(cfg)
    else:
        from blacklight.pipeline_simulation import make_simulation_renderer
        name = ("golden_polarized_rk4_32.input" if kind == "polarized"
                else "golden_sim_rk4_32.input")
        cfg = read_config(str(fixtures_dir / name))
        cfg.simulation_file = str(fixtures_dir / "mock_small.athdf")
        cfg.camera_resolution = 4
        cfg.precision = "float32"
        render, _, rays, _, _ = make_simulation_renderer(cfg)
    return render.lower(rays.positions, rays.directions,
                        rays.momentum_factors).as_text()


@pytest.mark.parametrize("kind", ["formula", "simulation", "polarized"])
def test_render_contractions_use_highest_precision(fixtures_dir, kind):
    """Every dot_general in the lowered float32 render asks for HIGHEST
    precision, so XLA:GPU cannot run it in TF32 (lowering only; nothing is
    compiled)."""
    text = _lowered_render(fixtures_dir, kind)
    dots = [line for line in text.splitlines() if "dot_general" in line]
    loose = [line.strip() for line in dots
             if not re.search(r"precision = \[HIGHEST, HIGHEST\]", line)]
    assert not loose, loose[:3]
    if kind != "formula":
        assert dots  # the simulation paths do contract (fluid frame)
