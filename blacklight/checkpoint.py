"""Geodesic and sampling checkpoints.

Capability parity with the reference's restart-from-phase checkpoints:
  - geodesic checkpoint (src/geodesic_integrator/geodesic_checkpoint.cpp:
    28-108): saves the traced ray bundle (camera rays + per-step sample
    positions/momenta/steps + flags) so reruns skip ray integration;
  - sampling checkpoint (src/radiation_integrator/sample_checkpoint.cpp:
    22-63): the reference saves the grid->ray index map; in the fused
    device design the equivalent precomputation is the sampled primitive
    values at every geodesic sample, saved per snapshot (like the
    reference, incompatible with slow light, radiation_integrator.cpp:
    209-210).

Format: a single .npz per checkpoint (instead of the reference's raw
binary dump, file_io.cpp:64-129) - portable, self-describing, and loadable
without the config that produced it.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from blacklight import native
from blacklight.ops import geodesic
from blacklight.utils.errors import BlacklightError


def _payload_crc(arrays: dict) -> np.ndarray:
    """CRC-32 over every array's raw bytes (key-sorted), via the native
    OpenMP slicing-by-8 kernel (native/blio.cpp blio_crc32) - plays the
    integrity role the reference's ZIP CRC does for its outputs
    (zip_format.cpp:289-362), here guarding checkpoint round-trips."""
    crc = 0
    for k in sorted(arrays):
        a = np.ascontiguousarray(np.atleast_1d(arrays[k]))
        crc = native.crc32(a.view(np.uint8).reshape(-1), seed=crc)
    return np.uint32(crc)


def _verify_crc(f, path: str) -> None:
    if "checksum" not in f.files:
        return  # pre-CRC checkpoint; accept
    stored = int(np.asarray(f["checksum"]))
    arrays = {k: f[k] for k in f.files if k != "checksum"}
    if int(_payload_crc(arrays)) != stored:
        raise BlacklightError(
            f"Checkpoint {path} failed CRC-32 integrity check.")


def validate_checkpoint_options(cfg) -> None:
    """Mutual-exclusion checks (geodesic_integrator.cpp:31-34,
    radiation_integrator.cpp:203-210)."""
    if cfg.require("checkpoint_geodesic_save") \
            and cfg.require("checkpoint_geodesic_load"):
        raise BlacklightError(
            "Cannot both save and load geodesic checkpoint.")
    sample_save = bool(cfg.checkpoint_sample_save)
    sample_load = bool(cfg.checkpoint_sample_load)
    if sample_save and sample_load:
        raise BlacklightError("Cannot both save and load sample checkpoint.")
    if bool(cfg.slow_light_on) and (sample_save or sample_load):
        raise BlacklightError("Cannot use sample checkpoints with slow light.")


def trace_and_save_geodesics(path: str, positions, directions,
                             momentum_factors, params) -> tuple:
    """Trace the ray bundle, compact it, truncate the step axis to the
    longest ray, and save. Returns (samples, flags, n_samples) for
    immediate use by the caller (the run that saves also renders)."""
    samples, flags, n_samples = jax.jit(
        lambda p, d: geodesic.trace_geodesics(p, d, params))(
            positions, directions)
    samples = geodesic.compact_samples(samples)
    n_max = max(int(jnp.max(n_samples)), 1)
    samples = geodesic.Sample(
        pos=samples.pos[:n_max], dir=samples.dir[:n_max],
        len=samples.len[:n_max], valid=samples.valid[:n_max])
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    arrays = dict(
        sample_pos=np.asarray(samples.pos),
        sample_dir=np.asarray(samples.dir),
        sample_len=np.asarray(samples.len),
        sample_valid=np.asarray(samples.valid),
        flags=np.asarray(flags),
        n_samples=np.asarray(n_samples),
        positions=np.asarray(positions),
        directions=np.asarray(directions),
        momentum_factors=np.asarray(momentum_factors))
    np.savez(path, checksum=_payload_crc(arrays), **arrays)
    return samples, flags, n_samples


def load_geodesics(path: str, dtype=jnp.float64):
    """Load a geodesic checkpoint written by trace_and_save_geodesics.

    Returns (samples, flags, n_samples) with (S, B, ...) device arrays.
    """
    if not os.path.exists(path):
        raise BlacklightError(f"Could not open file {path} for reading.")
    with np.load(path) as f:
        _verify_crc(f, path)
        samples = geodesic.Sample(
            pos=jnp.asarray(f["sample_pos"], dtype=dtype),
            dir=jnp.asarray(f["sample_dir"], dtype=dtype),
            len=jnp.asarray(f["sample_len"], dtype=dtype),
            valid=jnp.asarray(f["sample_valid"]))
        flags = jnp.asarray(f["flags"])
        n_samples = jnp.asarray(f["n_samples"])
    return samples, flags, n_samples


def save_samples(path: str, prims: dict) -> None:
    """Save sampled primitive values ((S, B) float32 per variable) - the
    fused design's analog of the reference's sample_inds/fracs maps."""
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    arrays = {k: np.asarray(v) for k, v in prims.items()}
    np.savez(path, checksum=_payload_crc(arrays), **arrays)


def load_samples(path: str) -> dict:
    if not os.path.exists(path):
        raise BlacklightError(f"Could not open file {path} for reading.")
    with np.load(path) as f:
        _verify_crc(f, path)
        return {k: jnp.asarray(f[k]) for k in f.files if k != "checksum"}
