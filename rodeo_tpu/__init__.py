r"""
rodeo-tpu: a probabilistic ODE solver and inference framework in JAX.

Re-architecture of the capabilities of ``mlysy/rodeo`` for accelerator
execution: batch-polymorphic Kalman kernels,
optional parallel-in-time associative-scan filtering/smoothing, SVD-free
sampling, fused lane-batched step functions (with GPU kernels) for the hot
scans, and device-mesh sharding
for vmapped MCMC chains and parameter sweeps.

Public API surface (matching the reference's re-exports,
``src/rodeo/__init__.py:1-6``):

- :func:`rodeo_tpu.solve_mv`, :func:`rodeo_tpu.solve_sim`
- :mod:`rodeo_tpu.interrogate`, :mod:`rodeo_tpu.prior`,
  :mod:`rodeo_tpu.inference`, :mod:`rodeo_tpu.kalmantv`,
  :mod:`rodeo_tpu.utils`
- extensions under :mod:`rodeo_tpu.ops` (parallel-in-time,
  fused step functions and GPU kernels, fast sampling) and
  :mod:`rodeo_tpu.parallel`
  (mesh/sharding helpers).
"""

__version__ = "0.5.0"

from rodeo_tpu import interrogate
from rodeo_tpu import prior
from rodeo_tpu import inference
from rodeo_tpu.solve import solve_sim, solve_mv
