"""blacklight: a differentiable general-relativistic ray tracer in JAX.

A from-scratch JAX/XLA re-design of the capabilities of c-white/blacklight
(GRMHD snapshot imaging via backward null geodesics + synchrotron radiative
transfer), built for accelerators:

- arrays-of-rays: every quantity is a batched jnp array over pixels,
- geodesic integration + radiative transfer fused into a single streaming
  `lax.scan` (no per-step path materialisation on the unpolarized path),
- full-Stokes polarized transfer as a chunked reverse scan,
- end-to-end differentiable (pixels -> fluid fields, plasma params, camera),
- pixels sharded over a `jax.sharding.Mesh` for multi-chip / multi-host runs.

Reference semantics: c-white/blacklight (cited per-module as file:line).
"""

__version__ = "0.1.0"

from blacklight.utils.config import Config, read_config

__all__ = ["Config", "read_config", "__version__"]
