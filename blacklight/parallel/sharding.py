"""Device-mesh sharding for pixel bundles.

The reference's only parallelism is OpenMP over pixels on one node
(SURVEY 2: blacklight.cpp:77, per-stage '#pragma omp parallel for').
Here the same axis - pixels/rays - shards over a jax.sharding.Mesh:
every per-pixel array in the fused scan carries a NamedSharding over its
leading axis, XLA SPMD partitions the whole computation with zero
collectives on the forward pass (rays are independent), and gradient
reductions become an all-reduce across the mesh under jax.grad.

The GRMHD grid (simulation model) is replicated per device here; grids too
large for one device shard in space (parallel/grid_sharding.py).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(devices: Optional[Sequence] = None, axis_name: str = "pixels") -> Mesh:
    """1-D mesh over all (or given) devices, pixels axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def shard_rays(positions, directions, momentum_factors, mesh: Mesh,
               axis_name: str = "pixels"):
    """Pad the pixel axis to a device multiple and place with NamedSharding.

    Returns (positions, directions, momentum_factors, orig_n). Padded rays
    are real rays duplicated from index 0; callers slice back to orig_n.
    """
    n = positions.shape[0]
    n_dev = mesh.devices.size
    n_pad = pad_to_multiple(n, n_dev)
    if n_pad != n:
        extra = n_pad - n
        positions = jnp.concatenate([positions, positions[:extra]], axis=0)
        directions = jnp.concatenate([directions, directions[:extra]], axis=0)
        momentum_factors = jnp.concatenate(
            [momentum_factors, momentum_factors[:extra]], axis=0)
    sharding = NamedSharding(mesh, P(axis_name))
    positions = jax.device_put(positions, sharding)
    directions = jax.device_put(directions, sharding)
    momentum_factors = jax.device_put(momentum_factors, sharding)
    return positions, directions, momentum_factors, n


def unshard(tree, orig_n: int):
    """Gather results to host and strip ray padding on the leading axis."""
    def fix(a):
        a = np.asarray(a)
        if a.ndim >= 1 and a.shape[0] >= orig_n:
            return a[:orig_n]
        return a
    return jax.tree.map(fix, tree)
