"""
Large-state workflow: a PDE semi-discretization as ONE dense block.

The reference's examples top out at 6 state variables
(`/root/reference/examples/timings.py`); this example runs the d=128
method-of-lines heat equation (state dim 384, `rodeo_tpu/models/heat.py`)
three ways and checks each against the discretized system's closed-form
solution (the initial profile is an exact Laplacian eigenvector):

1. the exact Taylor-preconditioned solver (`precond.solve_mv` — dense
   matmuls + Cholesky innovation solves via `ops/linalg.solve_psd`);
2. the stationary-gain solver (`ops/stationary.py` — exact Riccati
   warm-up, frozen gains, matvec-only mean scans; valid because the
   heat RHS is affine and time-invariant);
3. the stationary solver with marginal-only covariance output
   (`var_out="diag"` — the full covariance grid is the HBM wall for
   d >> 128);
4. PARAMETER INFERENCE in the same regime: the stationary fenrir
   likelihood (`ops.stationary.fenrir_stationary`) and its
   `jax.grad` w.r.t. the diffusivity kappa on ~20 noisy observations
   of the solution — the library's headline job, now at large-state
   cost O(n_warm + M log gap) instead of O(N) covariance steps (on
   CPU the value/gradient are cross-checked against the exact
   `precond.fenrir` path).

Run: python examples/large_state.py          (CPU, f64, small d)
     python examples/large_state.py --device (default accelerator, f32,
                                              the benchmark config)
"""
import os
import sys
import timeit

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

_DEVICE = "--device" in sys.argv

if not _DEVICE:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

from rodeo_tpu.interrogate import interrogate_kramer  # noqa: E402
from rodeo_tpu.models import heat                     # noqa: E402
from rodeo_tpu.ops import precond                     # noqa: E402
from rodeo_tpu.ops.stationary import solve_mv_stationary  # noqa: E402


def bench_one(tag, fn, exact, p, t_max):
    # simple block_until_ready timing of single calls (includes the host
    # dispatch of each call)
    mu = fn()[0]
    jax.block_until_ready(mu)
    t = min(timeit.repeat(lambda: jax.block_until_ready(fn()[0]),
                          number=1, repeat=3))
    err = float(np.max(np.abs(
        np.asarray(mu[-1, 0, ::p]) - exact(t_max))))
    print(f"{tag:>34s}: {t * 1e3:9.1f} ms   max|err| vs closed form "
          f"{err:.2e}")


def main():
    d = 128 if _DEVICE else 32
    n_steps = 1000 if _DEVICE else 200
    dtype = jnp.float32 if _DEVICE else jnp.float64
    cfg = heat.setup(d=d, n_deriv=3, n_steps=n_steps, dtype=dtype)
    exact = cfg.pop("exact")
    p = cfg.pop("n_deriv")
    print(f"heat equation d={d} (state dim {3 * d}), {n_steps} steps, "
          f"{jnp.zeros(0, dtype).dtype} on {jax.devices()[0]}")

    bench_one(
        "exact precond path", jax.jit(lambda: precond.solve_mv(
            key=None, interrogate=interrogate_kramer, n_deriv=p, **cfg)),
        exact, p, cfg["t_max"])
    bench_one(
        "stationary gains (n_warm=64)", jax.jit(lambda: solve_mv_stationary(
            key=None, interrogate=interrogate_kramer, n_deriv=p,
            n_warm=64, **cfg)),
        exact, p, cfg["t_max"])
    bench_one(
        "stationary, var_out='diag'", jax.jit(lambda: solve_mv_stationary(
            key=None, interrogate=interrogate_kramer, n_deriv=p,
            n_warm=64, var_out="diag", **cfg)),
        exact, p, cfg["t_max"])
    infer_kappa(cfg, exact, p, d, n_steps, dtype)


def infer_kappa(cfg, exact, p, d, n_steps, dtype):
    """Stationary fenrir: likelihood + gradient w.r.t. the diffusivity."""
    from rodeo_tpu.ops.stationary import fenrir_stationary

    # the shared benchmark fixture: 20 noisy full-state observations of
    # the closed-form solution, diffusivity exposed as `kappa`
    kw, kappa0 = heat.fenrir_setup(d=d, n_deriv=p, n_steps=n_steps,
                                   n_obs=20, dtype=dtype)
    results = {}
    # n_warm governs a freeze-accuracy dial (see fenrir_stationary's
    # ACCURACY MODEL): heat + diffuse prior is a SLOW-Riccati config, so
    # show the fast approximation next to the machine-exact full-prefix
    # mode (n_warm = n_steps), which is what gradient-based inference
    # should use here
    for tag, nw in (("n_warm=64 (frozen tail)", 64),
                    ("n_warm=n_steps (exact)", n_steps)):
        ll = jax.jit(lambda k, nw=nw: fenrir_stationary(
            n_deriv=p, n_warm=nw, kappa=k, **kw))
        vg = jax.jit(jax.value_and_grad(
            lambda k, nw=nw: fenrir_stationary(
                n_deriv=p, n_warm=nw, kappa=k, **kw)))
        v, g = vg(kappa0)
        jax.block_until_ready(g)
        t_ll = min(timeit.repeat(
            lambda: jax.block_until_ready(ll(kappa0)), number=1,
            repeat=3))
        t_vg = min(timeit.repeat(
            lambda: jax.block_until_ready(vg(kappa0)[1]), number=1,
            repeat=3))
        results[nw] = (float(v), float(g))
        print(f"{'fenrir ' + tag:>34s}: {t_ll * 1e3:9.1f} ms   "
              f"ll = {float(v):.2f}")
        print(f"{'  + grad d(ll)/d(kappa)':>34s}: {t_vg * 1e3:9.1f} ms   "
              f"grad = {float(g):.4g}")
    if not _DEVICE:
        from rodeo_tpu.ops import precond
        v_e, g_e = jax.value_and_grad(lambda k: precond.fenrir(
            n_deriv=p, kappa=k, **kw))(kappa0)
        v, g = results[n_steps]
        print(f"{'  exact-mode cross-check':>34s}: "
              f"|dll| = {abs(v - float(v_e)):.2e}, "
              f"|dgrad|/|grad| = "
              f"{abs(g - float(g_e)) / abs(float(g_e)):.2e}")

    # the DALTON counterpart (joint p(Z,Y) filter exact by construction,
    # marginal p(Z) filter frozen after n_warm; interrogation hoisted in
    # both passes)
    from rodeo_tpu.ops.stationary import dalton_stationary
    lld = jax.jit(lambda k: dalton_stationary(
        n_deriv=p, n_warm=n_steps, kappa=k, **kw))
    vd = lld(kappa0)
    jax.block_until_ready(vd)
    t_d = min(timeit.repeat(
        lambda: jax.block_until_ready(lld(kappa0)), number=1, repeat=3))
    print(f"{'dalton n_warm=n_steps (exact)':>34s}: {t_d * 1e3:9.1f} ms   "
          f"ll = {float(vd):.2f}")
    if not _DEVICE:
        vd_e = precond.dalton(n_deriv=p, kappa=kappa0, **kw)
        print(f"{'  dalton exact cross-check':>34s}: "
              f"|dll| = {abs(float(vd) - float(vd_e)):.2e}")

    # MAGI completes the trio — and needs NO dense/stationary machinery:
    # its measurement model is per-block identity, so the filter stays
    # block-diagonal at any d; the cross-variable coupling rides one
    # path-wide matmul inside ode_expand.  The fixture is the
    # f32-valid COARSE grid (N=25, matched sigma — see magi_setup's
    # docstring for the float32 validity rule); kappa is evaluated 5%
    # off truth so the gradient is informative (at truth the exact path
    # makes it vanish: truth is the MLE).
    from rodeo_tpu.ops import precond as _prec
    u_m, oe_m, pp_m, dt_m = heat.magi_setup(d=d, dtype=dtype)
    vgm = jax.jit(jax.value_and_grad(lambda k: _prec.magi_logdens(
        ode_data_subset=u_m, ode_expand=oe_m, n_active=2,
        prior_pars=pp_m, dt=dt_m, kappa=k)))
    k_m = jnp.asarray(0.0105, dtype)
    v_m, g_m = vgm(k_m)
    jax.block_until_ready(g_m)
    t_m = min(timeit.repeat(
        lambda: jax.block_until_ready(vgm(k_m)[1]), number=1, repeat=3))
    print(f"{'magi value+grad (N=25 grid)':>34s}: {t_m * 1e3:9.1f} ms   "
          f"ll = {float(v_m):.2f}, grad = {float(g_m):.4g}")


if __name__ == "__main__":
    main()
