"""Camera model: image frequencies, camera tetrad, per-pixel rays.

Re-derivation of the reference camera setup (src/geodesic_integrator/
camera.cpp:27-671) in batched jnp form. The scalar tetrad algebra runs once;
pixel positions/momenta are a single broadcast over the (u_ind, v_ind) grid
instead of the reference's per-pixel OpenMP loop (camera.cpp:390-413).

Everything is differentiable with respect to the camera parameters and spin.
"""

from __future__ import annotations

import dataclasses
import jax
import math
from typing import Optional

import jax.numpy as jnp
import numpy as np

from blacklight.constants import (
    HIGHEST,
    CameraType,
    FrequencyNormalization,
    FrequencySpacing,
)
from blacklight.ops import geometry


@dataclasses.dataclass(frozen=True)
class CameraGeometry:
    """Static camera frame quantities (reference camera.cpp:52-380)."""

    cam_x: jnp.ndarray        # (4,) camera position in CKS
    u_con: jnp.ndarray        # (4,) camera 4-velocity (contravariant)
    u_cov: jnp.ndarray        # (4,) camera 4-velocity (covariant)
    norm_con: jnp.ndarray     # (4,) normal direction, coordinate frame
    norm_con_c: jnp.ndarray   # (4,) normal direction, camera frame
    hor_con_c: jnp.ndarray    # (4,) horizontal direction, camera frame
    vert_con_c: jnp.ndarray   # (4,) vertical direction, camera frame


@dataclasses.dataclass(frozen=True)
class CameraRays:
    """Per-pixel ray bundle.

    positions/directions mirror camera_pos/camera_dir in the reference:
    position is the pixel's spacetime event, direction the *covariant*
    photon momentum p_mu; momentum_factors normalize ray frequency
    (camera.cpp:528-585, 608-671).
    """

    positions: jnp.ndarray          # (N, 4)
    directions: jnp.ndarray         # (N, 4) covariant
    momentum_factors: jnp.ndarray   # (N,)


def image_frequency_table(num_frequencies: int, frequency: float,
                          frequency_start: float = 0.0, frequency_end: float = 0.0,
                          spacing: FrequencySpacing = FrequencySpacing.lin_freq,
                          dtype=jnp.float64) -> jnp.ndarray:
    """Ideal image frequencies (reference camera.cpp:30-50)."""
    if num_frequencies == 1:
        return jnp.array([frequency], dtype=dtype)
    frac = np.arange(num_frequencies, dtype=np.float64) / (num_frequencies - 1)
    if spacing == FrequencySpacing.lin_freq:
        freqs = frequency_start + frac * (frequency_end - frequency_start)
    elif spacing == FrequencySpacing.lin_wave:
        freqs = 1.0 / (1.0 / frequency_start
                       + frac * (1.0 / frequency_end - 1.0 / frequency_start))
    else:  # log
        freqs = np.exp(np.log(frequency_start)
                       + frac * np.log(frequency_end / frequency_start))
    freqs[0] = frequency_start
    freqs[-1] = frequency_end
    return jnp.array(freqs, dtype=dtype)


def camera_geometry(*, bh_m: float, bh_a: float, camera_r: float, camera_th: float,
                    camera_ph: float, camera_urn: float, camera_uthn: float,
                    camera_uphn: float, camera_k_r: float, camera_k_th: float,
                    camera_k_ph: float, camera_rotation: float,
                    camera_pole: bool, ray_flat: bool,
                    dtype=jnp.float64) -> CameraGeometry:
    """Build the camera position, velocity, and orthonormal screen basis.

    Direct re-derivation of reference camera.cpp:52-380 with the same special
    cases: spherical-KS metric at the camera, flat-space branch (ray_flat),
    and the pole-on branch (theta in {0, pi}) that swaps to a Cartesian-like
    local frame.
    """
    sth, cth = math.sin(camera_th), math.cos(camera_th)
    sph, cph = math.sin(camera_ph), math.cos(camera_ph)
    srot, crot = math.sin(camera_rotation), math.cos(camera_rotation)

    # Camera position (camera.cpp:60-70)
    cam_t = 0.0
    cam_x1 = sth * (camera_r * cph - bh_a * sph)
    cam_x2 = sth * (camera_r * sph + bh_a * cph)
    cam_x3 = camera_r * cth
    if ray_flat:
        cam_x1 = camera_r * sth * cph
        cam_x2 = camera_r * sth * sph
    z_sign = 1.0 if cam_x3 >= 0.0 else -1.0

    # Metric in spherical coordinates at the camera (camera.cpp:72-150)
    a2 = bh_a * bh_a
    r2 = camera_r * camera_r
    delta = r2 - 2.0 * bh_m * camera_r + a2
    sigma = r2 + a2 * cth * cth
    if not ray_flat and not camera_pole:
        g_cov_r_r = 1.0 + 2.0 * bh_m * camera_r / sigma
        g_cov_r_th = 0.0
        g_cov_r_ph = -(1.0 + 2.0 * bh_m * camera_r / sigma) * bh_a * sth * sth
        g_cov_th_th = sigma
        g_cov_th_ph = 0.0
        g_cov_ph_ph = (r2 + a2 + 2.0 * bh_m * a2 * camera_r / sigma * sth * sth) * sth * sth
        g_con_t_t = -(1.0 + 2.0 * bh_m * camera_r / sigma)
        g_con_t_r = 2.0 * bh_m * camera_r / sigma
        g_con_t_th = 0.0
        g_con_t_ph = 0.0
        g_con_r_r = delta / sigma
        g_con_r_th = 0.0
        g_con_r_ph = bh_a / sigma
        g_con_th_th = 1.0 / sigma
        g_con_th_ph = 0.0
        g_con_ph_ph = 1.0 / (sigma * sth * sth)
    elif ray_flat and not camera_pole:
        g_cov_r_r, g_cov_r_th, g_cov_r_ph = 1.0, 0.0, 0.0
        g_cov_th_th, g_cov_th_ph = r2, 0.0
        g_cov_ph_ph = r2 * sth * sth
        g_con_t_t, g_con_t_r, g_con_t_th, g_con_t_ph = -1.0, 0.0, 0.0, 0.0
        g_con_r_r, g_con_r_th, g_con_r_ph = 1.0, 0.0, 0.0
        g_con_th_th, g_con_th_ph = 1.0 / r2, 0.0
        g_con_ph_ph = 1.0 / (r2 * sth * sth)
    elif camera_pole and not ray_flat:
        f = 2.0 * bh_m * camera_r / (r2 + a2)
        g_cov_r_r, g_cov_r_th, g_cov_r_ph = 1.0 + f, 0.0, 0.0
        g_cov_th_th, g_cov_th_ph, g_cov_ph_ph = 1.0, 0.0, 1.0
        g_con_t_t = -1.0 - f
        g_con_t_r = z_sign * f
        g_con_t_th, g_con_t_ph = 0.0, 0.0
        g_con_r_r, g_con_r_th, g_con_r_ph = 1.0 - f, 0.0, 0.0
        g_con_th_th, g_con_th_ph, g_con_ph_ph = 1.0, 0.0, 1.0
    else:  # ray_flat and camera_pole
        g_cov_r_r, g_cov_r_th, g_cov_r_ph = 1.0, 0.0, 0.0
        g_cov_th_th, g_cov_th_ph, g_cov_ph_ph = 1.0, 0.0, 1.0
        g_con_t_t, g_con_t_r, g_con_t_th, g_con_t_ph = -1.0, 0.0, 0.0, 0.0
        g_con_r_r, g_con_r_th, g_con_r_ph = 1.0, 0.0, 0.0
        g_con_th_th, g_con_th_ph, g_con_ph_ph = 1.0, 0.0, 1.0

    # Camera velocity in spherical coordinates (camera.cpp:152-164)
    alpha = 1.0 / math.sqrt(-g_con_t_t)
    beta_con_r = -g_con_t_r / g_con_t_t
    beta_con_th = -g_con_t_th / g_con_t_t
    beta_con_ph = -g_con_t_ph / g_con_t_t
    utn = math.sqrt(1.0 + g_cov_r_r * camera_urn**2
                    + 2.0 * g_cov_r_th * camera_urn * camera_uthn
                    + 2.0 * g_cov_r_ph * camera_urn * camera_uphn
                    + g_cov_th_th * camera_uthn**2
                    + 2.0 * g_cov_th_ph * camera_uthn * camera_uphn
                    + g_cov_ph_ph * camera_uphn**2)
    u_con_0 = utn / alpha
    ur = camera_urn - beta_con_r / alpha * utn
    uth = camera_uthn - beta_con_th / alpha * utn
    uph = camera_uphn - beta_con_ph / alpha * utn

    # Jacobian d(x,y,z)/d(r,th,ph) (camera.cpp:166-199)
    if camera_pole:
        dx_dr, dy_dr, dz_dr = 0.0, 0.0, z_sign
        dx_dth, dy_dth, dz_dth = 1.0, 0.0, 0.0
        dx_dph, dy_dph, dz_dph = 0.0, 1.0, 0.0
    elif ray_flat:
        dx_dr, dy_dr, dz_dr = sth * cph, sth * sph, cth
        dx_dth, dy_dth, dz_dth = camera_r * cth * cph, camera_r * cth * sph, -camera_r * sth
        dx_dph, dy_dph, dz_dph = -camera_r * sth * sph, camera_r * sth * cph, 0.0
    else:
        dx_dr, dy_dr, dz_dr = sth * cph, sth * sph, cth
        dx_dth = cth * (camera_r * cph - bh_a * sph)
        dy_dth = cth * (camera_r * sph + bh_a * cph)
        dz_dth = -camera_r * sth
        dx_dph = sth * (-camera_r * sph - bh_a * cph)
        dy_dph = sth * (camera_r * cph - bh_a * sph)
        dz_dph = 0.0

    # Camera velocity in CKS (camera.cpp:201-212)
    u_con = jnp.array([
        u_con_0,
        dx_dr * ur + dx_dth * uth + dx_dph * uph,
        dy_dr * ur + dy_dth * uth + dy_dph * uph,
        dz_dr * ur + dz_dth * uth + dz_dph * uph,
    ], dtype=dtype)
    cam_x = jnp.array([cam_t, cam_x1, cam_x2, cam_x3], dtype=dtype)
    g_cov = geometry.gcov(cam_x[1:], bh_a, bh_m, flat=ray_flat)
    u_cov = g_cov @ u_con

    # Photon momentum in spherical coordinates (camera.cpp:214-227)
    g_con_rn_rn = (g_con_t_t * g_con_r_r - g_con_t_r * g_con_t_r) / g_con_t_t
    g_con_rn_thn = (g_con_t_t * g_con_r_th - g_con_t_r * g_con_t_th) / g_con_t_t
    g_con_rn_phn = (g_con_t_t * g_con_r_ph - g_con_t_r * g_con_t_ph) / g_con_t_t
    g_con_thn_thn = (g_con_t_t * g_con_th_th - g_con_t_th * g_con_t_th) / g_con_t_t
    g_con_thn_phn = (g_con_t_t * g_con_th_ph - g_con_t_th * g_con_t_ph) / g_con_t_t
    g_con_phn_phn = (g_con_t_t * g_con_ph_ph - g_con_t_ph * g_con_t_ph) / g_con_t_t
    k_rn, k_thn, k_phn = camera_k_r, camera_k_th, camera_k_ph
    k_tn = -math.sqrt(g_con_rn_rn * k_rn**2 + 2.0 * g_con_rn_thn * k_rn * k_thn
                      + 2.0 * g_con_rn_phn * k_rn * k_phn + g_con_thn_thn * k_thn**2
                      + 2.0 * g_con_thn_phn * k_thn * k_phn + g_con_phn_phn * k_phn**2)
    k_t = alpha * k_tn + (beta_con_r * k_rn + beta_con_th * k_thn + beta_con_ph * k_phn)

    # Jacobian d(r,th,ph)/d(x,y,z) at the camera (camera.cpp:229-264)
    if camera_pole:
        dr_dx, dr_dy, dr_dz = 0.0, 0.0, z_sign
        dth_dx, dth_dy, dth_dz = 1.0, 0.0, 0.0
        dph_dx, dph_dy, dph_dz = 0.0, 1.0, 0.0
    elif ray_flat:
        dr_dx, dr_dy, dr_dz = cam_x1 / camera_r, cam_x2 / camera_r, cam_x3 / camera_r
        dth_dx = cth * cph / camera_r
        dth_dy = cth * sph / camera_r
        dth_dz = -sth / camera_r
        dph_dx = -sph / (camera_r * sth)
        dph_dy = cph / (camera_r * sth)
        dph_dz = 0.0
    else:
        rr2 = cam_x1**2 + cam_x2**2 + cam_x3**2
        dr_dx = camera_r * cam_x1 / (2.0 * r2 - rr2 + a2)
        dr_dy = camera_r * cam_x2 / (2.0 * r2 - rr2 + a2)
        dr_dz = (camera_r * cam_x3 + a2 * cam_x3 / camera_r) / (2.0 * r2 - rr2 + a2)
        dth_dx = cam_x3 * dr_dx / (r2 * sth)
        dth_dy = cam_x3 * dr_dy / (r2 * sth)
        dth_dz = (cam_x3 * dr_dz - camera_r) / (r2 * sth)
        dph_dx = -cam_x2 / (cam_x1**2 + cam_x2**2) + bh_a / (r2 + a2) * dr_dx
        dph_dy = cam_x1 / (cam_x1**2 + cam_x2**2) + bh_a / (r2 + a2) * dr_dy
        dph_dz = bh_a / (r2 + a2) * dr_dz

    # Photon momentum in CKS (camera.cpp:266-270)
    k_x = dr_dx * camera_k_r + dth_dx * camera_k_th + dph_dx * camera_k_ph
    k_y = dr_dy * camera_k_r + dth_dy * camera_k_th + dph_dy * camera_k_ph
    k_z = dr_dz * camera_k_r + dth_dz * camera_k_th + dph_dz * camera_k_ph
    k_tc = float(u_con[0]) * k_t + float(u_con[1]) * k_x \
        + float(u_con[2]) * k_y + float(u_con[3]) * k_z

    # Contravariant metric in camera frame (camera.cpp:272-280)
    g_con4 = geometry.gcon(cam_x[1:], bh_a, bh_m, flat=ray_flat)
    g_con4 = np.asarray(g_con4)
    u_con_np = np.asarray(u_con)
    u_cov_np = np.asarray(u_cov)
    g_con_c = g_con4[1:, 1:] + np.outer(u_con_np[1:], u_con_np[1:])

    # Camera normal direction in camera frame (camera.cpp:282-303)
    norm_cov_c = np.array([
        k_x - u_cov_np[1] / u_cov_np[0] * k_t,
        k_y - u_cov_np[2] / u_cov_np[0] * k_t,
        k_z - u_cov_np[3] / u_cov_np[0] * k_t,
    ])
    norm_con_c_spatial = g_con_c @ norm_cov_c
    norm_con_c0 = -k_tc
    norm_norm = math.sqrt(float(norm_cov_c @ norm_con_c_spatial))
    norm_cov_c = norm_cov_c / norm_norm
    norm_con_c = np.concatenate([[norm_con_c0 / norm_norm],
                                 norm_con_c_spatial / norm_norm])
    norm_con = np.empty(4)
    norm_con[0] = u_con_np[0] * norm_con_c[0] \
        - (u_cov_np[1] * norm_con_c[1] + u_cov_np[2] * norm_con_c[2]
           + u_cov_np[3] * norm_con_c[3]) / u_cov_np[0]
    norm_con[1:] = norm_con_c[1:] + u_con_np[1:] * norm_con_c[0]

    # Unprojected vertical direction in camera frame (camera.cpp:305-313)
    up_con_c = np.array([0.0, 0.0, 1.0])
    if camera_pole:
        up_con_c = np.array([0.0, 1.0, 0.0])

    # Covariant metric in camera frame (camera.cpp:315-333)
    g_cov_np = np.asarray(g_cov)
    ratio = u_cov_np[1:] / u_cov_np[0]
    g_cov_c = (g_cov_np[1:, 1:]
               - np.outer(ratio, g_cov_np[1:, 0])
               - np.outer(g_cov_np[1:, 0], ratio)
               + np.outer(ratio, ratio) * g_cov_np[0, 0])

    # Vertical direction without rotation (camera.cpp:335-354)
    up_norm = float(up_con_c @ norm_cov_c)
    vert_con_c_spatial = up_con_c - up_norm * norm_con_c[1:]
    vert_cov_c = g_cov_c @ vert_con_c_spatial
    vert_norm = math.sqrt(float(vert_cov_c @ vert_con_c_spatial))
    vert_cov_c = vert_cov_c / vert_norm
    vert_con_c_spatial = vert_con_c_spatial / vert_norm

    # Horizontal = normalized cross product via metric determinant
    # (camera.cpp:356-366)
    det = float(np.linalg.det(g_cov_c))
    det_sqrt = math.sqrt(det)
    hor_con_c_spatial = np.cross(vert_cov_c, norm_cov_c) / det_sqrt

    # Apply rotation (camera.cpp:368-380)
    hor_rot = hor_con_c_spatial * crot - vert_con_c_spatial * srot
    vert_rot = vert_con_c_spatial * crot + hor_con_c_spatial * srot

    return CameraGeometry(
        cam_x=cam_x,
        u_con=u_con,
        u_cov=u_cov,
        norm_con=jnp.array(norm_con, dtype=dtype),
        norm_con_c=jnp.array(norm_con_c, dtype=dtype),
        hor_con_c=jnp.array(np.concatenate([[0.0], hor_rot]), dtype=dtype),
        vert_con_c=jnp.array(np.concatenate([[0.0], vert_rot]), dtype=dtype),
    )


def pixel_grid(resolution: int, dtype=jnp.float64):
    """Fractional pixel coordinates (u_ind, v_ind) per reference camera.cpp:393-396.

    Returns two (resolution**2,) arrays in row-major pixel order
    (m2 = m // res is the vertical index, m1 = m % res horizontal).
    """
    idx = np.arange(resolution, dtype=np.float64)
    frac = (idx - resolution / 2.0 + 0.5) / resolution
    u_ind = np.tile(frac, resolution)
    v_ind = np.repeat(frac, resolution)
    return jnp.array(u_ind, dtype=dtype), jnp.array(v_ind, dtype=dtype)


def block_pixel_grid(block_u, block_v, block_size: int, effective_resolution: int,
                     dtype=jnp.float64):
    """Fractional pixel coordinates for adaptive blocks (camera.cpp:465-499).

    Args:
      block_u, block_v: (B,) integer block locations at this level.
      block_size: pixels per block side (adaptive_block_size).
      effective_resolution: camera_resolution * 2**level.

    Returns:
      (B * block_size**2,) u_ind and v_ind arrays, block-major then row-major.
    """
    block_u = np.asarray(block_u)
    block_v = np.asarray(block_v)
    m = np.arange(block_size * block_size)
    m2 = m // block_size
    m1 = m % block_size
    l_offset = (block_u * block_size)[:, None]
    m_offset = (block_v * block_size)[:, None]
    u_ind = (m1[None, :] + l_offset - effective_resolution / 2.0 + 0.5) / effective_resolution
    v_ind = (m2[None, :] + m_offset - effective_resolution / 2.0 + 0.5) / effective_resolution
    return (jnp.array(u_ind.reshape(-1), dtype=dtype),
            jnp.array(v_ind.reshape(-1), dtype=dtype))


def init_pixels(geom: CameraGeometry, u_ind, v_ind, *, camera_type: CameraType,
                bh_m: float, bh_a: float, camera_width: float, camera_r: float,
                image_normalization: FrequencyNormalization,
                ray_flat: bool = False) -> CameraRays:
    """Batched pixel positions + covariant momenta + momentum factors.

    Plane camera: reference camera.cpp:528-585 (SetPixelPlane).
    Pinhole camera: reference camera.cpp:608-671 (SetPixelPinhole).
    """
    dtype = geom.cam_x.dtype
    u = (u_ind * bh_m * camera_width).astype(dtype)
    v = (v_ind * bh_m * camera_width).astype(dtype)

    if camera_type == CameraType.plane:
        # Pixel displacement in camera frame -> coordinate frame
        d_c = u[:, None] * geom.hor_con_c[None, :] + v[:, None] * geom.vert_con_c[None, :]
        dt = geom.u_con[0] * d_c[:, 0] - (
            geom.u_cov[1] * d_c[:, 1] + geom.u_cov[2] * d_c[:, 2]
            + geom.u_cov[3] * d_c[:, 3]) / geom.u_cov[0]
        dxyz = d_c[:, 1:] + geom.u_con[1:][None, :] * d_c[:, 0:1]
        positions = jnp.concatenate(
            [(geom.cam_x[0] + dt)[:, None], geom.cam_x[1:][None, :] + dxyz], axis=-1)
        p_spatial = jnp.broadcast_to(geom.norm_con[1:], (u.shape[0], 3))
    else:
        positions = jnp.broadcast_to(geom.cam_x, (u.shape[0], 4))
        normalization = jnp.sqrt(u * u + v * v + camera_r * camera_r)
        frac_norm = camera_r / normalization
        frac_hor = -u / normalization
        frac_vert = -v / normalization
        dir_con_tc = geom.norm_con_c[0]
        dir_c = (frac_norm[:, None] * geom.norm_con_c[None, 1:]
                 + frac_hor[:, None] * geom.hor_con_c[None, 1:]
                 + frac_vert[:, None] * geom.vert_con_c[None, 1:])
        p_spatial = dir_c + geom.u_con[1:][None, :] * dir_con_tc

    # Null quadratic for p^0, then lower indices (camera.cpp:552-574)
    g_cov = geometry.gcov(positions[:, 1:], bh_a, bh_m, flat=ray_flat)
    p0 = geometry.null_momentum_time_component(g_cov, p_spatial)
    p_con = jnp.concatenate([p0[:, None], p_spatial], axis=-1)
    directions = jnp.einsum("...ij,...j->...i", g_cov, p_con,
                            precision=HIGHEST)

    # Momentum factor (camera.cpp:576-583)
    if image_normalization == FrequencyNormalization.camera:
        nu_local = -jnp.einsum("...i,i->...", directions, geom.u_con,
                               precision=HIGHEST)
    else:
        nu_local = -directions[:, 0]
    return CameraRays(positions=positions, directions=directions,
                      momentum_factors=1.0 / nu_local)


def make_camera(cfg, *, bh_m: float, bh_a: float, dtype=jnp.float64):
    """Build CameraGeometry + root-level CameraRays + frequency table from Config.

    The per-pixel construction (init_pixels: a camera-resolution-sized
    chain of ~75 array ops) runs under ONE jit: eagerly, every op would be
    compiled and dispatched to the device on its own. camera_geometry
    stays eager - it is host-scalar tetrad
    algebra with a handful of single-point metric evaluations.
    """
    geom = camera_geometry(
        bh_m=bh_m, bh_a=bh_a,
        camera_r=cfg.require("camera_r"), camera_th=cfg.require("camera_th"),
        camera_ph=cfg.require("camera_ph"), camera_urn=cfg.require("camera_urn"),
        camera_uthn=cfg.require("camera_uthn"), camera_uphn=cfg.require("camera_uphn"),
        camera_k_r=cfg.require("camera_k_r"), camera_k_th=cfg.require("camera_k_th"),
        camera_k_ph=cfg.require("camera_k_ph"),
        camera_rotation=cfg.require("camera_rotation"),
        camera_pole=cfg.require("camera_pole"), ray_flat=cfg.require("ray_flat"),
        dtype=dtype)
    resolution = cfg.require("camera_resolution")
    u_ind, v_ind = pixel_grid(resolution, dtype=dtype)

    def _pixels(geom_arrays, u_ind, v_ind):
        g = CameraGeometry(*geom_arrays)
        rays = init_pixels(
            g, u_ind, v_ind, camera_type=cfg.require("camera_type"),
            bh_m=bh_m, bh_a=bh_a, camera_width=cfg.require("camera_width"),
            camera_r=cfg.require("camera_r"),
            image_normalization=cfg.require("image_normalization"),
            ray_flat=cfg.require("ray_flat"))
        return rays.positions, rays.directions, rays.momentum_factors

    geom_arrays = (geom.cam_x, geom.u_con, geom.u_cov, geom.norm_con,
                   geom.norm_con_c, geom.hor_con_c, geom.vert_con_c)
    rays = CameraRays(*jax.jit(_pixels)(geom_arrays, u_ind, v_ind))
    num_freq = cfg.require("image_num_frequencies")
    if num_freq == 1:
        freqs = image_frequency_table(1, cfg.require("image_frequency"), dtype=dtype)
    else:
        freqs = image_frequency_table(
            num_freq, 0.0, cfg.require("image_frequency_start"),
            cfg.require("image_frequency_end"),
            cfg.require("image_frequency_spacing"), dtype=dtype)
    return geom, rays, freqs
