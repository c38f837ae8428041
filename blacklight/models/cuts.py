"""Geometric sample cuts shared by all models.

The reference applies these during sampling (simulation_sampling.cpp:238-295)
and in the formula coefficients (formula_coefficients.cpp:73-116): camera
radius, near/far half-space, spheres, midplane slab, arbitrary plane.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from blacklight.ops import geometry


@dataclasses.dataclass(frozen=True)
class GeometricCuts:
    camera_r: float
    omit_near: bool = False
    omit_far: bool = False
    omit_in: float = -1.0
    omit_out: float = -1.0
    midplane_theta: float = 0.0
    midplane_z: float = 0.0
    plane: bool = False
    plane_origin: tuple = (0.0, 0.0, 0.0)
    plane_normal: tuple = (0.0, 0.0, 1.0)

    @staticmethod
    def from_config(cfg) -> "GeometricCuts":
        return GeometricCuts(
            camera_r=cfg.require("camera_r"),
            omit_near=cfg.require("cut_omit_near"),
            omit_far=cfg.require("cut_omit_far"),
            omit_in=cfg.require("cut_omit_in"),
            omit_out=cfg.require("cut_omit_out"),
            midplane_theta=cfg.require("cut_midplane_theta"),
            midplane_z=cfg.require("cut_midplane_z"),
            plane=cfg.require("cut_plane"),
            plane_origin=(cfg.cut_plane_origin_x or 0.0,
                          cfg.cut_plane_origin_y or 0.0,
                          cfg.cut_plane_origin_z or 0.0),
            plane_normal=(cfg.cut_plane_normal_x or 0.0,
                          cfg.cut_plane_normal_y or 0.0,
                          cfg.cut_plane_normal_z or 0.0))


def geometric_keep(pos, spin, camera_x, cuts: GeometricCuts):
    """(B,) True where the sample survives all geometric cuts."""
    x, y, z = pos[..., 1], pos[..., 2], pos[..., 3]
    r = geometry.radius(pos[..., 1:4], spin)
    keep = r <= cuts.camera_r
    if cuts.omit_near or cuts.omit_far:
        dot = x * camera_x[1] + y * camera_x[2] + z * camera_x[3]
        if cuts.omit_near:
            keep &= ~(dot > 0.0)
        if cuts.omit_far:
            keep &= ~(dot < 0.0)
    if cuts.omit_in >= 0.0:
        keep &= ~(r < cuts.omit_in)
    if cuts.omit_out >= 0.0:
        keep &= ~(r > cuts.omit_out)
    if cuts.midplane_theta != 0.0:
        th = jnp.arccos(z / r)
        off = jnp.abs(th - jnp.pi / 2.0)
        if cuts.midplane_theta > 0.0:
            keep &= ~(off > cuts.midplane_theta)
        else:
            keep &= ~(off < -cuts.midplane_theta)
    if cuts.midplane_z != 0.0:
        if cuts.midplane_z > 0.0:
            keep &= ~(jnp.abs(z) > cuts.midplane_z)
        else:
            keep &= ~(jnp.abs(z) < -cuts.midplane_z)
    if cuts.plane:
        ox, oy, oz = cuts.plane_origin
        nx, ny, nz = cuts.plane_normal
        dot = (x - ox) * nx + (y - oy) * ny + (z - oz) * nz
        keep &= ~(dot < 0.0)
    return keep
