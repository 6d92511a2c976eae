r"""
Step-cost / utilization probe for solver and likelihood evaluations, the
device peak table, and the compile-cache rule of the repository's
on-device scripts.

:func:`profile_solve` times a jitted callable in steady state with
``jax.block_until_ready`` (JAX returns before the device finishes, so
every timed window ends on a block) and, given a FLOP model, reports the
achieved rate and its share of a device peak from :data:`PEAKS`.  The
benchmark harness (``bench.py``) times through the same function.
"""
import os
import time

import jax

__all__ = ["profile_solve", "PEAKS", "device_peaks", "compile_cache_dir",
           "use_compile_cache"]

#: Published dense peak rates, keyed by JAX's ``device_kind``: FLOP/s
#: for float32 outside the tensor cores, TF32 and bf16 on the tensor
#: cores, and device-memory bytes/s.  Source: NVIDIA's H100 data sheet,
#: SXM part, at its full 700 W power limit (a card set to a lower limit
#: cannot hold these clocks).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def device_peaks(device=None):
    """Peak rates of ``device`` (default: the first JAX device) from
    :data:`PEAKS`.  A device that is not in the table raises: a roofline
    share is never computed against an assumed peak."""
    device = device if device is not None else jax.devices()[0]
    kind = device.device_kind
    if kind not in PEAKS:
        raise KeyError(
            f"no published peaks for device_kind {kind!r}; add its data "
            "sheet rates to rodeo_tpu.ops.profile.PEAKS")
    return PEAKS[kind]


def compile_cache_dir(repo_root, environ=None):
    """Where JAX's persistent compile cache lives, and whether code must
    set it: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
    itself, so nothing is set in code), else the fixed
    ``<repo_root>/.jax_cache``.  Returns ``(path, set_in_code)``."""
    environ = os.environ if environ is None else environ
    env_dir = environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir, False
    return os.path.join(os.path.abspath(repo_root), ".jax_cache"), True


def use_compile_cache(repo_root):
    """Apply :func:`compile_cache_dir`; returns the cache path."""
    path, set_in_code = compile_cache_dir(repo_root)
    if set_in_code:
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def _timeit(fn, args, n_rep=5, per=1, min_window=0.3):
    """Steady-state seconds per unit of ``fn(*args)``: one warm-up call
    (compilation), then windows of back-to-back calls that each end in
    ``jax.block_until_ready``, doubling the call count until a window
    lasts ``min_window`` seconds.  A unit is one of the ``per``
    evaluations each call performs (e.g. one lane of a batched solve).
    Returns ``(seconds_per_unit, last_output)``."""
    out = jax.block_until_ready(fn(*args))
    reps = max(int(n_rep), 1)
    while True:
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        total = time.perf_counter() - t0
        if total >= min_window or reps >= 4096:
            break
        reps = min(4096, 2 * reps)
    return total / (reps * per), out


def profile_solve(fn, *args, per=1, n_rep=5, min_window=0.3,
                  flops_per_eval=None, peak_flops=None, **kwargs):
    r"""
    Measure the steady-state device cost of one evaluation of ``fn``.

    ``fn(*args, **kwargs)`` should be a jitted callable (it is called
    once for warm-up/compilation before timing begins).

    Args:
        per (int): evaluations performed by ONE call of ``fn`` (e.g. the
            lane count of a batched solve); results are per evaluation.
        n_rep (int): starting repetition count (doubled until the timed
            window lasts ``min_window`` seconds).
        min_window (float): minimum wall-clock window in seconds.
        flops_per_eval (float | None): a FLOP model for one evaluation.
            When given, the result gains ``achieved_flops`` and — with
            ``peak_flops`` — ``utilization``.
        peak_flops (float | None): device peak for the unit doing the
            work, e.g. ``device_peaks()["f32_flops"]``.

    Returns:
        dict: ``ms`` (per evaluation), ``evals_per_sec``; plus
        ``achieved_flops`` / ``utilization`` when the models are
        supplied.
    """
    call = (lambda *a: fn(*a, **kwargs)) if kwargs else fn
    sec, _ = _timeit(call, args, n_rep=n_rep, per=per,
                     min_window=min_window)
    out = {"ms": sec * 1e3, "evals_per_sec": 1.0 / sec}
    if flops_per_eval is not None:
        out["flops_per_eval"] = float(flops_per_eval)
        out["achieved_flops"] = float(flops_per_eval) / sec
        if peak_flops is not None:
            out["utilization"] = float(flops_per_eval) / sec / peak_flops
    return out
