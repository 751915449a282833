"""NumPy reference oracles for bit-match testing (never used in production).

Copies of ``husky_rover_mppi_isaacsim_tpu/compat``, so that they run where
the JAX package cannot be imported (where jax is not installed):

- :mod:`warp_oracle`: scalar NumPy mirror of the Warp production kernels.
- :mod:`numpy_oracle`: mirror of the thesis ``python_mppi_projection``
  reference implementation (the BASELINE bit-match spec).
"""

from . import numpy_oracle, warp_oracle

__all__ = ["numpy_oracle", "warp_oracle"]
