"""Agreement of two renders of one image under different arithmetic.

Photon-ring pixels orbit the hole many times and are chaotic: any two
arithmetic schedules (float32 vs float64, GPU vs CPU, two reduction orders)
diverge there, so a per-pixel tolerance fails on a handful of pixels that
carry almost no flux. The gate is statistical instead:

- identical NaN sets (NaN marks a by-design fallback, never noise);
- fewer than 0.5% of pixels beyond 1e-3 relative error, where the error is
  relative to the pixel itself, floored at 1e-6 of the image's peak;
- total flux within 1e-3, relative to the total absolute flux (so signed
  Stokes Q, U and V, whose sums may cancel, are held to the same scale).
"""

from __future__ import annotations

import numpy as np

REL_TOL = 1e-3
MAX_FRAC_BEYOND = 5e-3
FLUX_TOL = 1e-3
# A whole float32 render against float64 meets neither per-pixel bound:
# float32 fixed-step (rk4/rk2) geodesics of plunging rays drift by ~1e-3 M
# near the horizon, and float32 Faraday rotation loses phase, moving those
# pixels by up to tens of percent and total flux by up to 1.3e-3 (formula
# goldens at 16^2-64^2 on the CPU). The float32 transfer on float64
# geodesics does meet the gate. A whole float32 render is held to identical
# NaN sets and total flux within ten times that drift.
FLOAT32_FLUX_TOL = 1e-2


def image_agreement(test, ref) -> dict:
    """Compare `test` with the reference render `ref` (same shape).

    Returns a dict with the gate's three statistics and `ok`."""
    test = np.asarray(test, np.float64)
    ref = np.asarray(ref, np.float64)
    if test.shape != ref.shape:
        raise ValueError(f"shape mismatch: {test.shape} vs {ref.shape}")
    nan_match = bool(np.array_equal(np.isnan(test), np.isnan(ref)))
    peak = np.nanmax(np.abs(ref)) if np.isfinite(ref).any() else 0.0
    rel = np.abs(test - ref) / (np.abs(ref) + peak * 1e-6 + 1e-300)
    frac_beyond = float(np.mean(np.nan_to_num(rel) > REL_TOL))
    scale = np.nansum(np.abs(ref))
    flux_rel = float(abs(np.nansum(test) - np.nansum(ref)) / scale) \
        if scale > 0 else float(np.nansum(np.abs(test)) > 0)
    ok = nan_match and frac_beyond < MAX_FRAC_BEYOND and flux_rel < FLUX_TOL
    return {"ok": ok, "nan_match": nan_match, "frac_beyond": frac_beyond,
            "flux_rel": flux_rel}
