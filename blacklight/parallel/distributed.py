"""Multi-process orchestration: one process per host, all its cards local.

The reference has no distributed layer at all (SURVEY 2/5.8: composition is
by separate invocations + join_outputs.py).

On one GPU host, four cards are ONE process with four local devices: no
initialization is needed, `jax.devices()` lists every card, and the pixel
mesh (`parallel/sharding.make_mesh`) or the ('rays', 'grid') mesh
(`parallel/grid_sharding.make_grid_mesh`) spans them directly. The mesh
follows the algorithm (rays are independent; the grid splits in phi), not
the interconnect.

Across hosts a run is:

  1. `initialize(coordinator_address, num_processes, process_id)` on every
     host, with all three given explicitly - nothing in the environment
     configures a GPU cluster;
  2. build the global pixel mesh with `pod_mesh()`;
  3. shard the camera bundle with `shard_rays(...)` - each host holds only
     its local pixel rows;
  4. run the same fused render under jit with pixel shardings: XLA SPMD
     partitions everything, the forward pass needs zero collectives (rays
     are independent), and any gradient reduction becomes an all-reduce;
  5. gather per-host image pieces with `jax.experimental.multihost_utils`
     or write per-host npz files and merge with scripts/join_outputs.py.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

from blacklight.parallel.sharding import make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed handshake for a multi-host run; a no-op when already
    initialized or when no coordinator is given (one process per run, the
    single-host case).

    Must run before anything initializes the XLA backend (jax.devices()
    etc.), so the already-initialized check inspects the distributed
    global state rather than process_count()."""
    state = getattr(jax.distributed, "global_state", None)
    if state is not None and getattr(state, "client", None) is not None:
        return  # already initialized
    if coordinator_address is None:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def pod_mesh(axis_name: str = "pixels") -> Mesh:
    """1-D global mesh over every device of every process."""
    return make_mesh(jax.devices(), axis_name)


def local_slice(n: int) -> slice:
    """The [start, stop) pixel range this process owns for an n-ray bundle
    sharded over the global mesh (block distribution by process index)."""
    nproc = jax.process_count()
    pid = jax.process_index()
    per = -(-n // nproc)
    return slice(pid * per, min((pid + 1) * per, n))
