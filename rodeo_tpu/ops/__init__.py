r"""
Compute-path extensions:

- :mod:`rodeo_tpu.ops.precond` — Taylor-mode preconditioning (float32-
  stable solvers and likelihoods).
- :mod:`rodeo_tpu.ops.ptime` — parallel-in-time associative-scan Kalman
  filtering/smoothing and the iterated solver.
- :mod:`rodeo_tpu.ops.stationary` — stationary-gain dense solver for
  affine time-invariant ODEs (large-state regime).
- :mod:`rodeo_tpu.ops.pallas_kalman` — fused lane-batched filter/smoother
  step functions (scan driver; GPU kernels in
  :mod:`rodeo_tpu.ops.triton_kalman`).
- :mod:`rodeo_tpu.ops.flat_rows` — the ``*_flat`` model contract, checked
  on every driver and evaluated per block row inside the GPU kernels.
- :mod:`rodeo_tpu.ops.linalg` — closed-form tiny-matrix solves
  (``fast_linalg`` context).
- :mod:`rodeo_tpu.ops.scan` — the solver time-loop driver, the
  ``scan_unroll`` trace-time context, and the one platform decision
  (``kernel_route``).
- :mod:`rodeo_tpu.ops.profile` — ``profile_solve`` step-cost /
  utilization probe, the device peak table and the compile-cache rule
  (the bench harness's timer as a public API).
"""
from rodeo_tpu.ops import linalg
from rodeo_tpu.ops import precond
from rodeo_tpu.ops import ptime
from rodeo_tpu.ops import stationary
from rodeo_tpu.ops.scan import scan_unroll
from rodeo_tpu.ops.profile import profile_solve
