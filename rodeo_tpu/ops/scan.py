r"""
Trace-time scan configuration for the time-stepping loops.

The solver/inference layers run their per-step recursions with
``jax.lax.scan``.  Unrolling several steps per loop iteration can expose
instruction-level parallelism across consecutive steps and amortize loop
bookkeeping; the default is ``unroll=1``, and :func:`scan_unroll` sets
an explicit factor.  Unrolling replays the identical per-step graph, so
results are unchanged up to XLA fusion rounding.

This module is also the one place that decides how the fused step
functions (:mod:`rodeo_tpu.ops.pallas_kalman` and its siblings) run:
:func:`kernel_route` picks the hand-written GPU kernel on a GPU backend
and the plain :func:`scan_steps` driver everywhere else.

Usage (trace-time, like :func:`rodeo_tpu.ops.linalg.fast_linalg`)::

    from rodeo_tpu.ops.scan import scan_unroll

    with scan_unroll(8):
        ll = jax.jit(jax.vmap(lambda th: precond.fenrir(...)))(thetas)

The context must be active while the function is being *traced* (the first
jitted call); the unroll factor is baked into the compiled program.
"""
import contextlib
import threading

import jax
import jax.numpy as jnp

__all__ = ["scan", "scan_unroll", "get_scan_unroll",
           "scan_remat", "get_scan_remat", "scan_steps", "kernel_route",
           "fused_route"]

_state = threading.local()


def get_scan_unroll():
    """Current ambient unroll factor for solver time loops (``None`` =
    unset, i.e. ``unroll=1``)."""
    return getattr(_state, "unroll", None)


@contextlib.contextmanager
def scan_unroll(n):
    """Trace-time context: run solver time loops with ``lax.scan``
    ``unroll=n`` (``n`` consecutive steps per compiled loop iteration)."""
    prev = get_scan_unroll()
    _state.unroll = int(n)
    try:
        yield
    finally:
        _state.unroll = prev


def get_scan_remat():
    """Whether solver time-loop bodies are rematerialized (default False)."""
    return getattr(_state, "remat", False)


@contextlib.contextmanager
def scan_remat(enable=True):
    """Trace-time context: wrap every solver time-loop body in
    ``jax.checkpoint`` — reverse-mode differentiation then recomputes the
    per-step intermediates instead of storing them all, trading FLOPs for
    the HBM traffic that dominates gradient evaluations of long scans.
    Identical values and gradients."""
    prev = get_scan_remat()
    _state.remat = bool(enable)
    try:
        yield
    finally:
        _state.remat = prev


def scan(f, init, xs=None, length=None, reverse=False):
    """``jax.lax.scan`` with the ambient :func:`scan_unroll` /
    :func:`scan_remat` settings."""
    if get_scan_remat():
        f = jax.checkpoint(f)
    return jax.lax.scan(f, init, xs, length=length, reverse=reverse,
                        unroll=get_scan_unroll() or 1)


def scan_steps(step, carry, xs, reverse=False):
    """Run a fused step function over the leading (time) axis of ``xs``.

    ``step(carry, x_t) -> (carry, outs)`` is pure: ``carry`` is a pytree
    of column tiles ``(n_block, n_lane)``, ``x_t`` the step-``t`` slice of
    ``xs``, and ``outs`` a tuple of lists of column tiles.  Each list is
    stacked per step, so output ``k`` comes back as
    ``(n_steps, len(outs[k]), n_block, n_lane)``.  This is the plain XLA
    driver: the CPU path, the reference for the GPU kernels, and the GPU
    path wherever no kernel exists.
    """
    def body(c, x):
        c, outs = step(c, x)
        return c, tuple(jnp.stack(o) for o in outs)

    return scan(body, carry, xs, reverse=reverse)


def kernel_route():
    """The platform decision for the fused step functions: ``"triton"``
    (the Pallas-through-Triton kernels of
    :mod:`rodeo_tpu.ops.triton_kalman`) on a GPU backend, ``"scan"``
    (:func:`scan_steps` under XLA) on every other backend — unless a
    :func:`fused_route` context is active.  Nothing runs a kernel through
    the Pallas interpreter outside the tests."""
    route = getattr(_state, "route", None)
    if route is not None:
        return route
    return "triton" if jax.default_backend() == "gpu" else "scan"


@contextlib.contextmanager
def fused_route(route):
    """Trace-time context: run the fused step functions on ``route``
    (``"scan"`` or ``"triton"``) whatever the backend — for timing one
    driver against the other on the same card.  Like :func:`scan_unroll`
    it must be active while a function is first traced: a jitted function
    already traced for some argument shapes keeps the route it was traced
    with."""
    if route not in ("scan", "triton"):
        raise ValueError(f"route must be 'scan' or 'triton', got {route!r}")
    prev = getattr(_state, "route", None)
    _state.route = route
    try:
        yield
    finally:
        _state.route = prev
