#!/usr/bin/env python
"""Run the main path once on the GPU and check that what comes out is right.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the multi-card path only

One-card phases, each through the entry points a user calls (``cli.main``,
``pipeline.run`` and the ``make_*_renderer`` functions they use):

  golden      three golden formula inputs through cli.main in float64,
              compared with the reference binary's images;
  formula     the reference formula example (dp) at 1024^2 in float32;
  simulation  a 288x128x128 harm3d snapshot at 512^2 (thermal, rk4);
  polarized   the same snapshot in full Stokes at 256^2;
  gradient    d(total flux)/d(cn0, r0, h) of the formula fit model at
              256^2, reverse mode through the scan, against finite
              differences in float64.

Each phase prints one line: what ran, rays/s, wall and compile seconds, and
every check beside its tolerance. A subset of each render is rendered
again in float64 on the card and on the host CPU, and the two are held to
the statistical gate of blacklight/utils/compare.py; the float32 render is
held to the card's float64 on NaN sets and total flux. The last line is one
JSON object naming the device; it is printed only when every phase passed.
With no GPU, or when a phase raises or misses its tolerance, the script
exits non-zero without it.

One JAX process owns the card: it reserves most of the card's memory when
it starts, so nothing else may use the card while this runs.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import numpy as np  # noqa: E402

from blacklight import cli, pipeline, read_config  # noqa: E402
from blacklight.pipeline_simulation import (  # noqa: E402
    make_simulation_renderer)
from blacklight.utils.compare import (  # noqa: E402
    FLOAT32_FLUX_TOL, FLUX_TOL, MAX_FRAC_BEYOND, REL_TOL, image_agreement)

FIXTURES = ROOT / "tests" / "fixtures"

# Reference-binary goldens and the CPU tests' own tolerances
# (tests/test_formula_e2e.py): rk4/rk2 reproduce the reference to float64
# accumulation accuracy; dp agrees at quadrature-convergence level.
GOLDENS = [
    ("golden_formula_32", "dp"),
    ("golden_formula_cam_rk4_32", "exact"),
    ("golden_formula_rk2_32", "exact"),
]
EXACT_RTOL = 1e-7
DP_MAX_REL, DP_MEAN_REL = 5e-3, 1e-3

FORMULA_RES = 1024
SIM_GRID = dict(n_r=288, n_th=128, n_ph=128)  # EHT-library resolution
SIM_RES = 512
SIM_STEPS = 2000
POL_RES = 256
POL_STEPS = 512
GRAD_RES = 256
GRAD_PARAMS = ("cn0", "r0", "h")
# The h gradient vanishes at h = 0 (a thin disk is symmetric in h), so the
# gradient phase differentiates around a thick disk.
GRAD_BASE_H = 0.4
FD_REL_EPS = 1e-4
# Reverse-mode in float32 against central differences in float64. The
# float32 rk4 geodesics of plunging rays drift by ~1e-3 M near the horizon,
# which moves total flux by up to ~1e-3 relative (golden rk4 configs, CPU);
# float64 central differences at 1e-4 relative steps are good to ~1e-8, and
# the card's atomic scatter-adds reorder the reverse sums at ~1e-6. 1e-2
# leaves a factor of ten over the largest of these.
GRAD_RTOL = 1e-2
SUBSET_SIDE = {"formula": 128, "simulation": 64, "polarized": 64}
# Four cards: the pixel-sharded formula leg keeps 1024^2 and cuts the step
# budget so that one card's quarter of the reverse scan fits in memory.
FOUR_FORMULA_STEPS = 600
FOUR_SIM_RES = 256
FOUR_CARDS = 4


class PhaseFailed(Exception):
    """A phase ran but missed a tolerance."""


def card_line() -> str:
    """The cards as nvidia-smi reports name and power limit (no JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip()) or out.stderr.strip()


def gate_text(name: str, agreement: dict) -> str:
    return (f"{name}: nan_match={agreement['nan_match']} "
            f"frac>{REL_TOL:g}={agreement['frac_beyond']:.6g} "
            f"(tol <{MAX_FRAC_BEYOND:g}) "
            f"flux_rel={agreement['flux_rel']:.6g} (tol <{FLUX_TOL:g})")


def strided_subset(res: int, side: int) -> np.ndarray:
    """Pixel indices of a side x side grid spread evenly over a res^2
    image, so the subset spans the disk, the photon ring and the shadow."""
    stride = res // side
    rows = np.arange(side) * stride + stride // 2
    return (rows[:, None] * res + rows[None, :]).reshape(-1)


def with_output(cfg, tmp: pathlib.Path, name: str):
    cfg.output_file = str(tmp / f"{name}.npz")
    return cfg


def run_report(cfg):
    """pipeline.run with its stage timing report (the reference's format,
    src/blacklight.cpp:259-269) parsed: (arrays, {"total", "read",
    "image"} seconds)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        arrays = pipeline.run(cfg)
    text = out.getvalue()

    def seconds(label):
        return float(re.search(label + r":\s+([0-9.eE+-]+) s", text).group(1))

    return arrays, {"total": seconds("Elapsed time"),
                    "read": seconds("Time reading simulation data"),
                    "image": seconds(r"Time integrating rays\+sample\+image")}


def timed_run(cfg):
    """pipeline.run twice: cold (compile + run) and warm. The renderer is
    rebuilt on each call, so the warm call's compile is a persistent-cache
    load. Returns (arrays, cold, warm) with run_report's timings."""
    _, cold = run_report(cfg)
    arrays, warm = run_report(cfg)
    return arrays, cold, warm


def timing_text(n_rays: int, cold: dict, warm: dict) -> str:
    """rays/s of the warm render; compile is the cold render's excess."""
    return (f"{n_rays / warm['image']:.1f} rays/s, render {warm['image']:.3f}"
            f" s warm / {cold['image']:.3f} s cold, compile "
            f"{cold['image'] - warm['image']:.2f} s, snapshot read "
            f"{warm['read']:.2f} s, run wall {warm['total']:.3f} s warm / "
            f"{cold['total']:.3f} s cold")


def reference_renders(make_renderer, cfg, pixels, keys):
    """float64 renders of the given pixels on the card and on the host CPU.

    Returns {"gpu": {key: (n, ...)}, "cpu": {...}}."""
    import jax

    cfg64 = dataclasses.replace(cfg, precision="float64")
    out = {}
    for where, device in (("gpu", jax.devices()[0]),
                          ("cpu", jax.devices("cpu")[0])):
        with jax.default_device(device):
            render_fn, _, rays, _, _ = make_renderer(cfg64)
            image = render_fn(rays.positions[pixels], rays.directions[pixels],
                              rays.momentum_factors[pixels])
        out[where] = {k: np.asarray(image[k])[:, 0] for k in keys}
    return out


def check_against_references(test: dict, refs: dict) -> tuple[bool, list]:
    """Gate the card's float64 render against the host CPU's with the full
    statistical gate, and the card's float32 production render against the
    card's float64 on NaN sets and total flux (FLOAT32_FLUX_TOL, whose
    note says why float32 is held to no per-pixel bound)."""
    ok, parts = True, []
    for key, value in test.items():
        dev = image_agreement(refs["gpu"][key], refs["cpu"][key])
        f32 = image_agreement(value, refs["gpu"][key])
        ok = (ok and dev["ok"] and f32["nan_match"]
              and f32["flux_rel"] < FLOAT32_FLUX_TOL)
        parts.append(gate_text(f"{key} f64 card vs f64 cpu", dev))
        parts.append(f"{key} f32 card vs f64 card: "
                     f"nan_match={f32['nan_match']} "
                     f"flux_rel={f32['flux_rel']:.6g} "
                     f"(tol <{FLOAT32_FLUX_TOL:g}), "
                     f"frac>{REL_TOL:g}={f32['frac_beyond']:.6g} (not gated)")
    return ok, parts


# ---------------------------------------------------------------------------
# One-card phases


def phase_golden(tmp: pathlib.Path) -> tuple[bool, str]:
    ok, parts = True, []
    t_all = time.perf_counter()
    for name, kind in GOLDENS:
        text = (FIXTURES / f"{name}.input").read_text()
        text = re.sub(r"(?m)^output_file\s*=.*$",
                      f"output_file = {tmp / name}.npz", text)
        inp = tmp / f"{name}.input"
        inp.write_text(text)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main([str(inp)])
        wall = time.perf_counter() - t0
        if rc != 0:
            raise PhaseFailed(f"cli.main({name}) returned {rc}")
        image = np.squeeze(np.load(tmp / f"{name}.npz")["I_nu"])
        gold = np.squeeze(np.load(FIXTURES / f"{name}.npz")["I_nu"])
        nan_ok = np.array_equal(np.isnan(image), np.isnan(gold))
        fin = np.isfinite(gold)
        if kind == "exact":
            rel = np.abs(image[fin] - gold[fin]) / np.abs(gold[fin])
            worst = float(np.max(rel, initial=0.0))
            case_ok = nan_ok and worst <= EXACT_RTOL
            parts.append(f"{name} ({wall:.1f} s): max rel {worst:.3g} "
                         f"(tol {EXACT_RTOL:g}) nan_match={nan_ok}")
        else:
            rel = np.abs(image - gold) / (np.abs(gold)
                                          + np.nanmax(gold) * 1e-8)
            mx, mean = float(np.nanmax(rel)), float(np.nanmean(rel))
            case_ok = nan_ok and mx < DP_MAX_REL and mean < DP_MEAN_REL
            parts.append(f"{name} ({wall:.1f} s): max rel {mx:.3g} "
                         f"(tol <{DP_MAX_REL:g}) mean rel {mean:.3g} "
                         f"(tol <{DP_MEAN_REL:g}) nan_match={nan_ok}")
        ok = ok and case_ok
    wall = time.perf_counter() - t_all
    rays = len(GOLDENS) * 32 * 32
    return ok, (f"cli.main float64 32^2 x{len(GOLDENS)}: "
                f"{rays / wall:.1f} rays/s, wall {wall:.2f} s "
                f"(compile included); " + "; ".join(parts))


def loop_iterations(cfg) -> int:
    """Iterations the early-exit step loop of the formula render takes for
    the whole camera: a geodesic-only run of the same loop, counting."""
    import jax
    import jax.numpy as jnp

    from blacklight.camera import make_camera
    from blacklight.ops import geodesic

    bh_m, bh_a, _ = pipeline.bh_mass_spin(cfg)
    dtype = pipeline.compute_dtype(cfg)
    _, rays, _ = make_camera(cfg, bh_m=bh_m, bh_a=bh_a, dtype=dtype)
    params = pipeline.geodesic_params_from_config(cfg, bh_m, bh_a)
    count = jax.jit(lambda p, d: geodesic.streaming_reduce(
        p, d, params, lambda n, sample: n + 1, jnp.asarray(0, jnp.int32),
        early_exit=True)[0])
    return int(count(rays.positions, rays.directions))


def phase_formula(tmp: pathlib.Path, res: int = FORMULA_RES,
                  side: int = SUBSET_SIDE["formula"]) -> tuple[bool, str]:
    cfg = read_config(str(FIXTURES / "golden_formula_32.input"))
    cfg.camera_resolution = res
    cfg.precision = "float32"
    with_output(cfg, tmp, "formula")
    arrays, cold, warm = timed_run(cfg)
    n = res * res
    iters = loop_iterations(cfg)
    pixels = strided_subset(res, side)
    test = {"I_nu": np.asarray(arrays["I_nu"]).reshape(-1)[pixels]}
    refs = reference_renders(pipeline.make_formula_renderer, cfg, pixels,
                             ["I_nu"])
    ok, parts = check_against_references(test, refs)
    return ok, (f"pipeline.run formula dp float32 {res}^2: "
                f"{timing_text(n, cold, warm)}; step loop {iters} "
                f"iterations, {1e3 * warm['image'] / max(iters, 1):.4f} "
                f"ms/iteration; "
                f"subset {side}x{side} strided: " + "; ".join(parts))


def write_mock(tmp: pathlib.Path, grid: dict) -> str:
    """The analytic torus (scripts/generate_mock_simulation.py) as a
    harm3d file, which needs no h5py."""
    import generate_mock_simulation as gen

    p = dict(gen.DEFAULTS, **grid)
    path = str(tmp / "mock.harm")
    gen.write_harm3d(path, gen.make_fields(p), p)
    return path


def sim_config(mock: str, tmp: pathlib.Path, name: str, res: int,
               steps: int, polarized: bool = False):
    """golden_sim_rk4_32.input's settings on the harm3d mock, with the
    loader tests' sampling overrides (tests/test_loaders.py BASE_CONFIG):
    no NaN fallback and plasma kept inside r = 20.5, the mock torus's
    extent."""
    from blacklight.constants import SimulationFormat

    cfg = read_config(str(FIXTURES / "golden_sim_rk4_32.input"))
    cfg.simulation_format = SimulationFormat.harm3d
    cfg.simulation_file = mock
    cfg.fallback_nan = False
    cfg.fallback_rho = 1.0e-8
    cfg.fallback_pgas = 1.0e-10
    cfg.cut_omit_out = 20.5
    cfg.camera_resolution = res
    cfg.ray_max_steps = steps
    cfg.precision = "float32"
    cfg.image_polarization = polarized
    return with_output(cfg, tmp, name)


def phase_simulation(tmp: pathlib.Path, mock: str, res: int = SIM_RES,
                     steps: int = SIM_STEPS,
                     side: int = SUBSET_SIDE["simulation"]
                     ) -> tuple[bool, str]:
    import jax

    cfg = sim_config(mock, tmp, "simulation", res, steps)
    arrays, cold, warm = timed_run(cfg)
    peak = jax.devices()[0].memory_stats() or {}
    pixels = strided_subset(res, side)
    test = {"I_nu": np.asarray(arrays["I_nu"]).reshape(-1)[pixels]}
    refs = reference_renders(make_simulation_renderer, cfg, pixels, ["I_nu"])
    ok, parts = check_against_references(test, refs)
    return ok, (f"pipeline.run harm3d {SIM_GRID['n_r']}x{SIM_GRID['n_th']}x"
                f"{SIM_GRID['n_ph']} thermal rk4 {steps} steps float32 "
                f"{res}^2: {timing_text(res * res, cold, warm)}; peak "
                f"device bytes so far "
                f"{peak.get('peak_bytes_in_use', 'not reported')}; "
                f"subset {side}x{side} strided: " + "; ".join(parts))


def phase_polarized(tmp: pathlib.Path, mock: str, res: int = POL_RES,
                    steps: int = POL_STEPS,
                    side: int = SUBSET_SIDE["polarized"]) -> tuple[bool, str]:
    cfg = sim_config(mock, tmp, "polarized", res, steps, polarized=True)
    arrays, cold, warm = timed_run(cfg)
    pixels = strided_subset(res, side)
    keys = ["I_nu", "Q_nu", "U_nu", "V_nu"]
    test = {k: np.asarray(arrays[k]).reshape(-1)[pixels] for k in keys}
    refs = reference_renders(make_simulation_renderer, cfg, pixels, keys)
    ok, parts = check_against_references(test, refs)
    return ok, (f"pipeline.run harm3d polarized IQUV rk4 {steps} steps "
                f"float32 {res}^2: {timing_text(res * res, cold, warm)}; "
                f"subset {side}x{side} strided: "
                + "; ".join(parts))


def formula_loss(cfg, dtype, base_overrides: dict, early_exit: bool):
    """(loss, theta0, rays) for the formula fit model: loss(theta) is the
    total flux as a function of the fit parameters in the dict theta
    (optionally of the ray bundle too), theta0 their base values."""
    import jax.numpy as jnp

    from blacklight.camera import make_camera
    from blacklight.models import formula as formula_model
    from blacklight.transfer.unpolarized import (ImageOptions,
                                                 integrate_unpolarized)

    bh_m, bh_a, mass_msun = pipeline.bh_mass_spin(cfg)
    geom, rays, freqs = make_camera(cfg, bh_m=bh_m, bh_a=bh_a, dtype=dtype)
    params = pipeline.geodesic_params_from_config(cfg, bh_m, bh_a)
    base = dataclasses.replace(
        formula_model.formula_params_from_config(cfg), **base_overrides)

    def loss(theta, positions=rays.positions, directions=rays.directions,
             momentum_factors=rays.momentum_factors):
        fp = dataclasses.replace(base, **theta)

        def coeff_fn(p, k):
            j, alpha, _, bad = formula_model.formula_coefficients(
                p, k, momentum_factors, freqs, fp, geom.cam_x)
            return j, alpha, bad

        img = integrate_unpolarized(
            positions, directions, momentum_factors, freqs, params=params,
            coeff_fn=coeff_fn, opts=ImageOptions(fallback_nan=False),
            mass_msun=mass_msun, camera_x=geom.cam_x,
            log_j_scale=formula_model.formula_log_j_scale(fp),
            early_exit=early_exit)
        return jnp.nansum(img["I_nu"])

    theta0 = {k: getattr(base, k) for k in GRAD_PARAMS}
    return loss, theta0, rays


def fit_config(res: int, steps: int | None = None):
    import fit_demo

    from blacklight.utils.config import parse_config

    cfg = parse_config(fit_demo.CONFIG)
    cfg.camera_resolution = res
    if steps is not None:
        cfg.ray_max_steps = steps
    return cfg


def phase_gradient(res: int = GRAD_RES) -> tuple[bool, str]:
    import jax
    import jax.numpy as jnp

    cfg = fit_config(res)
    overrides = {"h": GRAD_BASE_H}
    loss32, theta0, _ = formula_loss(cfg, jnp.float32, overrides, False)
    theta32 = {k: jnp.asarray(v, jnp.float32) for k, v in theta0.items()}
    grad_fn = jax.jit(jax.value_and_grad(loss32))
    t0 = time.perf_counter()
    jax.block_until_ready(grad_fn(theta32))
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, grads = jax.block_until_ready(grad_fn(theta32))
    warm = time.perf_counter() - t0

    loss64, _, _ = formula_loss(cfg, jnp.float64, overrides, True)
    f64 = jax.jit(loss64)
    ok, parts = True, []
    for name in GRAD_PARAMS:
        x0 = theta0[name]
        eps = abs(x0) * FD_REL_EPS
        up = {k: jnp.asarray(v + (eps if k == name else 0.0), jnp.float64)
              for k, v in theta0.items()}
        dn = {k: jnp.asarray(v - (eps if k == name else 0.0), jnp.float64)
              for k, v in theta0.items()}
        fd = (float(f64(up)) - float(f64(dn))) / (2 * eps)
        ad = float(grads[name])
        rel = abs(ad - fd) / abs(fd) if fd != 0 else float("inf")
        ok = ok and np.isfinite(ad) and rel < GRAD_RTOL
        parts.append(f"d/d{name}: ad {ad:.6g} fd {fd:.6g} rel {rel:.3g} "
                     f"(tol <{GRAD_RTOL:g})")
    return ok, (f"jax.value_and_grad formula fit model rk4 "
                f"{cfg.ray_max_steps} steps float32 {res}^2 (h={GRAD_BASE_H}):"
                f" {res * res / warm:.1f} rays/s forward+backward, wall "
                f"{warm:.3f} s warm / {cold:.3f} s cold, compile "
                f"{cold - warm:.2f} s; ad float32 vs central fd float64 on "
                f"the card: " + "; ".join(parts))


# ---------------------------------------------------------------------------
# Four cards


def phase_pixel_sharded(n_cards: int, res: int = FORMULA_RES,
                        steps: int = FOUR_FORMULA_STEPS) -> tuple[bool, str]:
    """Pixel-sharded forward and backward of the formula fit model over
    n_cards, against the same step run on one card, quarter by quarter."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from blacklight.parallel.sharding import make_mesh, shard_rays

    cfg = fit_config(res, steps)
    loss, theta0, rays = formula_loss(cfg, jnp.float32, {"h": GRAD_BASE_H},
                                      False)
    theta = {k: jnp.asarray(v, jnp.float32) for k, v in theta0.items()}
    step = jax.value_and_grad(loss)

    devices = jax.devices()[:n_cards]
    mesh = make_mesh(devices)
    pos, dirs, mom, n = shard_rays(rays.positions, rays.directions,
                                   rays.momentum_factors, mesh)
    if n != pos.shape[0]:
        raise PhaseFailed(f"{n} rays do not divide over {n_cards} cards")
    pixel = NamedSharding(mesh, P("pixels"))
    rep = NamedSharding(mesh, P())
    sharded = jax.jit(step, in_shardings=(rep, pixel, pixel, pixel),
                      out_shardings=(rep, rep))
    theta_rep = jax.device_put(theta, rep)
    t0 = time.perf_counter()
    jax.block_until_ready(sharded(theta_rep, pos, dirs, mom))
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    val_s, grad_s = jax.block_until_ready(sharded(theta_rep, pos, dirs, mom))
    warm = time.perf_counter() - t0

    one = jax.jit(step)
    chunk = n // n_cards
    val_1, grad_1 = 0.0, {k: 0.0 for k in theta}
    with jax.default_device(devices[0]):
        for i in range(n_cards):
            sl = slice(i * chunk, (i + 1) * chunk)
            v, g = one(theta, rays.positions[sl], rays.directions[sl],
                       rays.momentum_factors[sl])
            val_1 += float(v)
            for k in theta:
                grad_1[k] += float(g[k])
    # Each card sums its quarter in float32 in another fusion order than the
    # one-card program, and the all-reduce adds the quarters in float32:
    # reordering ~2.6e5 terms moves a float32 sum by ~sqrt(n) eps = 3e-5.
    rtol = 1e-4
    rels = {"flux": abs(float(val_s) - val_1) / abs(val_1)}
    rels.update({f"d/d{k}": abs(float(grad_s[k]) - grad_1[k])
                 / abs(grad_1[k]) for k in theta})
    ok = all(np.isfinite(r) and r < rtol for r in rels.values())
    return ok, (f"pixel-sharded value_and_grad formula fit model float32 "
                f"{res}^2, {steps} steps (cut from "
                f"{fit_config(res).ray_max_steps} to fit one card's quarter"
                f" of the reverse scan), {n_cards} cards: "
                f"{n / warm:.1f} rays/s forward+backward, wall {warm:.3f} s"
                f" warm / {cold:.3f} s cold; vs one card in {n_cards} "
                f"chunks: " + ", ".join(f"{k} rel {v:.3g}" for k, v in
                                         rels.items())
                + f" (tol <{rtol:g})")


def phase_grid_sharded(tmp: pathlib.Path, mock: str, n_cards: int,
                       res: int = FOUR_SIM_RES) -> tuple[bool, str]:
    """The production mock with its grid sharded in phi over a
    ('rays', 'grid') = (1, n_cards) mesh, against the replicated
    one-card renderer."""
    import jax
    import jax.numpy as jnp

    from blacklight.camera import make_camera
    from blacklight.parallel.grid_sharding import (make_grid_mesh,
                                                   make_sharded_renderer)
    from blacklight.pipeline_simulation import load_grid
    from blacklight.transfer.unpolarized import ImageOptions

    cfg = sim_config(mock, tmp, "grid_sharded", res, SIM_STEPS)
    bh_m, bh_a, mass_msun = pipeline.bh_mass_spin(cfg)
    grid, _ = load_grid(cfg, dtype=jnp.float32)
    geom, rays, freqs = make_camera(cfg, bh_m=bh_m, bh_a=bh_a,
                                    dtype=jnp.float32)
    params = pipeline.geodesic_params_from_config(cfg, bh_m, bh_a)
    mesh = make_grid_mesh(1, n_cards, devices=jax.devices()[:n_cards])
    render = make_sharded_renderer(cfg, grid, geom, freqs, mesh, mass_msun,
                                   params, ImageOptions.from_config(cfg))
    t0 = time.perf_counter()
    render(rays.positions, rays.directions, rays.momentum_factors)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded = render(rays.positions, rays.directions,
                     rays.momentum_factors)["I_nu"]
    warm = time.perf_counter() - t0
    del grid

    with jax.default_device(jax.devices()[0]):
        render_fn, _, rays1, _, _ = make_simulation_renderer(cfg)
        single = render_fn(rays1.positions, rays1.directions,
                           rays1.momentum_factors)["I_nu"]
    agreement = image_agreement(sharded, single)
    worst = float(np.nanmax(np.abs(sharded - single)
                            / (np.abs(single) + 1e-300)))
    return agreement["ok"], (
        f"grid-sharded harm3d {SIM_GRID['n_r']}x{SIM_GRID['n_th']}x"
        f"{SIM_GRID['n_ph']} rk4 {SIM_STEPS} steps float32 {res}^2 on a "
        f"('rays', 'grid') = (1, {n_cards}) mesh: {res * res / warm:.1f} "
        f"rays/s, wall {warm:.3f} s warm / {cold:.3f} s cold; corner psums "
        f"reorder sums, so vs the replicated one-card render: "
        + gate_text("I_nu", agreement) + f", max rel {worst:.3g}")


# ---------------------------------------------------------------------------


def run_phases(phases) -> bool:
    all_ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            ok, line = fn()
        except Exception as exc:  # report every phase, then fail
            traceback.print_exc()
            ok, line = False, f"raised {exc!r}"
        status = "PASS" if ok else "FAIL"
        print(f"[{name}] {status} ({time.perf_counter() - t0:.1f} s) {line}",
              flush=True)
        all_ok = all_ok and ok
    return all_ok


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the multi-card path on four cards")
    args = parser.parse_args(argv)

    # The float64 references also run on the host CPU, so keep its backend
    # available where the environment names the platforms.
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    import jax

    try:
        devices = jax.devices()
    except RuntimeError as exc:
        print(f"no accelerator: {exc}", file=sys.stderr)
        return 2
    if any(d.platform != "gpu" for d in devices):
        print(f"chip_smoke needs GPUs; JAX found {devices}", file=sys.stderr)
        return 2
    need = FOUR_CARDS if args.four_cards else 1
    if len(devices) < need:
        print(f"need {need} cards, JAX found {len(devices)}", file=sys.stderr)
        return 2

    from blacklight.utils.cache import enable_compilation_cache

    jax.config.update("jax_enable_x64", True)
    cache_dir = enable_compilation_cache()
    import jaxlib
    try:
        import h5py  # noqa: F401
        has_h5py = "yes"
    except ImportError:
        has_h5py = "no"
    print(f"card: {card_line()} | jax {jax.__version__} jaxlib "
          f"{jaxlib.__version__} | h5py importable: {has_h5py} | "
          f"compile cache: {cache_dir} | devices: {len(devices)} x "
          f"{devices[0].device_kind}", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp_name:
        tmp = pathlib.Path(tmp_name)
        t0 = time.perf_counter()
        mock = write_mock(tmp, SIM_GRID)
        print(f"[setup] harm3d mock {SIM_GRID} written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if args.four_cards:
            phases = [
                ("pixel_sharded",
                 lambda: phase_pixel_sharded(FOUR_CARDS)),
                ("grid_sharded",
                 lambda: phase_grid_sharded(tmp, mock, FOUR_CARDS)),
            ]
        else:
            phases = [
                ("golden", lambda: phase_golden(tmp)),
                ("formula", lambda: phase_formula(tmp)),
                ("simulation", lambda: phase_simulation(tmp, mock)),
                ("polarized", lambda: phase_polarized(tmp, mock)),
                ("gradient", phase_gradient),
            ]
        ok = run_phases(phases)
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
