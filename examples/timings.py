"""
Timing harness reproducing the reference JSS preprint Table 3
(upstream ``examples/timings.py``): wall-clock of the probabilistic
solver against LSODA, against RK45 (diffrax Dopri5 when available, scipy
solve_ivp RK45 otherwise -- diffrax is not in this image), and against the
non-blocked (dense, `indep_init`) variant, on the preprint's benchmark
systems (Chkrebtii q=4, FitzHugh-Nagumo, Hes1, SEIRAH) plus Lorenz63.

Run: python examples/timings.py          (CPU, f64 — the preprint's setup)
     python examples/timings.py --device (default accelerator, f32,
                                          Taylor-preconditioned solver;
                                          LSODA/RK45 stay on host CPU)
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

import rodeo_tpu
from rodeo_tpu.ops import precond
from rodeo_tpu.prior import indep_init
from rodeo_tpu.interrogate import interrogate_kramer
from rodeo_tpu.models import fitzhugh, hes1, seirah, lorenz
from scipy.integrate import odeint, solve_ivp

try:  # RK45 column: diffrax Dopri5 as upstream (`timings.py:81-109`) ...
    import diffrax
except ImportError:  # ... scipy's RK45 otherwise
    diffrax = None

N_LOOPS = 20


def _rk45_bench(odeint_fun, x0_ode, t_min, t_max, th_np, tseq):
    if diffrax is not None:
        term = diffrax.ODETerm(
            lambda t, y, args: jnp.asarray(odeint_fun(y, t, args)))
        solver = diffrax.Dopri5()
        sol = jax.jit(lambda y0: diffrax.diffeqsolve(
            term, solver, t0=t_min, t1=t_max, dt0=tseq[1] - tseq[0],
            y0=y0, args=th_np,
            saveat=diffrax.SaveAt(ts=jnp.asarray(tseq))).ys)
        return _bench(lambda: sol(jnp.asarray(x0_ode)))
    return _bench(lambda: solve_ivp(
        lambda t, y: odeint_fun(y, t, th_np), (t_min, t_max), x0_ode,
        method="RK45", t_eval=tseq))


def _bench(fn, *args):
    out = fn(*args)  # warm up / compile
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(3):
        t0 = timeit.default_timer()
        for _ in range(N_LOOPS):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, timeit.default_timer() - t0)
    return best / N_LOOPS


def time_model(name, model, odeint_fun, x0_ode, n_steps, t_max):
    dtype = jnp.float32 if _DEVICE else jnp.float64
    cfg = model.setup(n_steps=n_steps, t_max=t_max, dtype=dtype)
    theta = cfg.pop("theta")

    # on an f32 accelerator the raw covariance filter NaNs once the IBM
    # prior's dynamic range exceeds ~1e7; the Taylor-preconditioned solver
    # is the honest f32 configuration (identical posterior).  Accelerator
    # wall-clocks amortize the fixed host-dispatch latency over B
    # sequential solves inside one jitted lax.map, as bench.py measures.
    solve_fn = precond.solve_mv if _DEVICE else rodeo_tpu.solve_mv
    n_amortize = 64 if _DEVICE else 1
    thetas = (jnp.broadcast_to(theta, (n_amortize,) + theta.shape)
              if theta is not None else jnp.zeros((n_amortize, 1), dtype))
    solve = jax.jit(lambda ths: jax.lax.map(lambda th: solve_fn(
        key=None, interrogate=interrogate_kramer,
        theta=th if theta is not None else None, **cfg)[0], ths))
    out = solve(thetas)
    if bool(jnp.any(jnp.isnan(out))):
        raise RuntimeError(f"{name}: blocked solve produced NaNs")
    t_blocked = _bench(
        lambda ths: solve(ths), thetas) / n_amortize

    # non-blocked: collapse the prior into one dense block
    dense_prior = indep_init(cfg["prior_pars"])
    n_block, _, n_deriv = cfg["ode_weight"].shape
    W_dense = jnp.zeros((1, n_block, n_block * n_deriv))
    for b in range(n_block):
        W_dense = W_dense.at[0, b, b * n_deriv:(b + 1) * n_deriv].set(
            cfg["ode_weight"][b, 0])
    x0_dense = cfg["ode_init"].reshape(1, -1)
    ode_fun = cfg["ode_fun"]

    def ode_dense(X, t, **params):
        return ode_fun(X.reshape(n_block, n_deriv), t, **params)[:, 0][None]

    # the dense variant runs Taylor-preconditioned too (tiled per-variable
    # scaling, `precond.solve_mv(n_deriv=...)`): the raw dense filter is
    # numerically unstable with interrogate_kramer — the upstream
    # implementation diverges on this config as well (finite but wrong),
    # while the preconditioned dense solve converges to the blocked answer
    W_dense = W_dense.astype(dtype)
    solve_nb = jax.jit(lambda ths: jax.lax.map(
        lambda th: precond.solve_mv(
            key=None, ode_fun=ode_dense, ode_weight=W_dense,
            ode_init=x0_dense, t_min=cfg["t_min"], t_max=cfg["t_max"],
            n_steps=cfg["n_steps"], interrogate=interrogate_kramer,
            prior_pars=dense_prior, n_deriv=n_deriv,
            theta=th if theta is not None else None)[0], ths))
    if bool(jnp.any(jnp.isnan(solve_nb(thetas)))):
        t_dense = float("nan")
    else:
        t_dense = _bench(
            lambda ths: solve_nb(ths),
            thetas) / n_amortize

    tseq = np.linspace(cfg["t_min"], cfg["t_max"], n_steps + 1)
    th_np = np.asarray(theta) if theta is not None else None
    t_lsoda = _bench(lambda: odeint(odeint_fun, x0_ode, tseq, args=(th_np,)))
    t_rk45 = _rk45_bench(odeint_fun, x0_ode, cfg["t_min"], cfg["t_max"],
                         th_np, tseq)

    print(f"{name:10s}  rodeo-tpu {t_blocked*1e3:7.2f} ms | "
          f"LSODA/rodeo {t_lsoda/t_blocked:5.2f}x | "
          f"RK45/rodeo {t_rk45/t_blocked:5.2f}x | "
          f"dense/blocked {t_dense/t_blocked:5.2f}x")


def main():
    def chkrebtii_np(X, t, th):
        return np.array([X[1], np.sin(2 * t) - X[0]])

    def fitz_np(X, t, th):
        a, b, c = th
        V, R = X
        return np.array([c * (V - V ** 3 / 3 + R), -1 / c * (V - a + b * R)])

    def hes1_np(X, t, th):
        a, b, c, d, e, f, g = th
        P, M, H = np.exp(X)
        return np.array([-a * H + b * M / P - c,
                         -d + e / (1 + P ** 2) / M,
                         -a * P + f / (H * (1 + P ** 2)) - g])

    def seirah_np(X, t, th):
        b, r, alpha, D_e, D_I, D_q = th
        S, E, I, R, A, H = X
        N = X.sum()
        D_h = 30.0
        dS = -b * S * (I + alpha * A) / N
        dE = b * S * (I + alpha * A) / N - E / D_e
        dI = r * E / D_e - I / D_q - I / D_I
        dR = (I + A) / D_I + H / D_h
        dA = (1 - r) * E / D_e - A / D_I
        dH = I / D_q - H / D_h
        return np.array([dS, dE, dI, dR, dA, dH])

    def lorenz_np(X, t, th):
        rho, sigma, beta = th
        x, y, z = X
        return np.array([-sigma * x + sigma * y, rho * x - y - x * z,
                         -beta * z + x * y])

    from rodeo_tpu.models import chkrebtii
    time_model("Chkrebtii", chkrebtii, chkrebtii_np,
               np.array([-1.0, 0.0]), 30, 10.0)
    time_model("FitzHugh", fitzhugh, fitz_np,
               np.array([-1.0, 1.0]), 250, 10.0)
    time_model("Hes1", hes1, hes1_np,
               np.log(np.array([1.439, 2.037, 17.904])), 120, 240.0)
    time_model("SEIRAH", seirah, seirah_np,
               np.array(seirah.X0), 80, 60.0)
    time_model("Lorenz63", lorenz, lorenz_np,
               np.array([-12.0, -5.0, 38.0]), 4000, 20.0)


if __name__ == "__main__":
    main()
