r"""
Method-of-lines heat equation — the large-state benchmark system.

The 1-D heat equation :math:`\partial_t u = \kappa \, \partial_x^2 u` on
:math:`x \in (0, 1)` with zero boundaries, discretized on :math:`d`
interior points, is the linear ODE system

.. math::

    \dot u = L u, \qquad
    L = \frac{\kappa}{h^2} \operatorname{tridiag}(1, -2, 1),
    \quad h = \frac{1}{d+1},

which exercises the solver regime the reference's benchmark suite never
touches: a *dense coupled* state (one block of ``d * n_deriv`` entries,
e.g. 384 at ``d=128``) where every filter step is large matmuls and
an :math:`O(d)`-dimensional innovation solve, instead of Table-3's
:math:`d \le 6` toy systems (reference models: ``examples/timings.py``).

The default initial profile :math:`u_0(x) = \sin(\pi x)` sampled on the
grid is an **exact eigenvector** of the discrete Laplacian
(eigenvalue :math:`\mu_1 = -\tfrac{2\kappa}{h^2}(1 - \cos \pi h)`), so the
discretized system has the closed form :math:`u(t) = e^{\mu_1 t} u_0` —
an analytic accuracy anchor that needs no CPU reference run.
"""
import numpy as np
import jax
import jax.numpy as jnp

from rodeo_tpu.prior import ibm_init
from rodeo_tpu.prior.indep_init import indep_init

__all__ = ["laplacian", "heat_fun", "setup", "fenrir_setup", "magi_setup"]

KAPPA = 0.01


def laplacian(d, kappa=KAPPA, dtype=np.float64):
    """Dense discrete Laplacian ``(kappa/h^2) tridiag(1, -2, 1)``,
    ``h = 1/(d+1)``."""
    L = (np.diag(-2.0 * np.ones(d))
         + np.diag(np.ones(d - 1), 1)
         + np.diag(np.ones(d - 1), -1)) * float((d + 1) ** 2) * kappa
    return L.astype(dtype)


def heat_fun(L, n_deriv):
    """Block-form RHS ``X -> (L @ u)[None, :]`` with ``u = X[0, ::n_deriv]``
    (single dense block, interleaved derivative layout as produced by
    :func:`rodeo_tpu.prior.indep_init`)."""
    def ode_fun(X_t, t, **params):
        u = X_t[0, ::n_deriv]
        return (L @ u)[None, :]
    return ode_fun


def setup(d=128, n_deriv=3, n_steps=1000, t_min=0.0, t_max=1.0,
          kappa=KAPPA, prior_sigma=5e3, dtype=jnp.float32):
    """Solver configuration for the ``d``-dimensional heat benchmark.

    Returns the usual config dict (``ode_fun``/``ode_weight``/``ode_init``/
    grid/``prior_pars``) plus:

    * ``"exact"``: callable ``t -> u(t)`` — the closed-form solution of the
      *discretized* system (valid because ``u0`` is an eigenvector);
    * ``"n_deriv"``: the per-variable derivative count, for
      :func:`rodeo_tpu.ops.precond.solve_mv`'s dense-layout scaling.

    The solution state interleaves derivatives (``x[0, j::n_deriv]`` is the
    ``j``-th derivative of ``u``), matching ``indep_init``'s dense layout.
    """
    p = n_deriv
    n_bstate = d * p
    L = laplacian(d, kappa)
    Lj = jnp.asarray(L, dtype)

    # observe the 1st derivative of each variable: W x = du/dt
    W = np.zeros((1, d, n_bstate))
    for i in range(d):
        W[0, i, i * p + 1] = 1.0

    # u0 = leading Laplacian eigenvector; higher Taylor coefficients are
    # exact powers L^j u0
    u0 = np.sin(np.pi * np.arange(1, d + 1) / (d + 1))
    x0 = np.zeros((1, n_bstate))
    uj = u0
    for j in range(p):
        x0[0, j::p] = uj
        uj = L @ uj

    mu1 = -2.0 * (1.0 - np.cos(np.pi / (d + 1))) * float((d + 1) ** 2) * kappa

    def exact(t):
        return np.exp(mu1 * (t - t_min)) * u0

    dt = (t_max - t_min) / n_steps
    prior_pars = indep_init(ibm_init(
        dt, p, jnp.full((d,), prior_sigma, dtype)))
    return dict(
        ode_fun=heat_fun(Lj, p),
        ode_weight=jnp.asarray(W, dtype),
        ode_init=jnp.asarray(x0, dtype),
        t_min=t_min, t_max=t_max, n_steps=n_steps,
        prior_pars=jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, dtype), prior_pars),
        exact=exact,
        n_deriv=p,
    )


def magi_setup(d=128, n_deriv=3, n_active=2, n_steps=25, t_min=0.0,
               t_max=1.0, kappa=KAPPA, prior_sigma=0.02, dtype=jnp.float32):
    """MAGI configuration for the heat benchmark — BLOCKED layout.

    Unlike fenrir/dalton, MAGI needs no dense/stationary machinery in the
    large-state regime: its filter has no interrogation step, so the
    cross-variable coupling enters only through ``ode_expand`` (here one
    path-wide matmul with the Laplacian) and the Kalman recursion
    stays block-diagonal — ``d`` independent ``(n_deriv, n_deriv)``
    filters, exactly the regime the blocked kernels already handle
    (reference semantics: ``/root/reference/src/rodeo/inference/magi.py``,
    whose measurement model is per-block identity).

    Returns ``(u, ode_expand, prior_pars, dt)``: ``u`` is the
    ODE-consistent path subset (the closed-form solution and its first
    ``n_active - 1`` time-derivatives on the grid) of shape
    ``(n_steps + 1, d, n_active)``; ``ode_expand`` appends the
    ``n_deriv``-th Taylor coefficient via the ODE
    (:math:`x^{(j+1)} = L x^{(j)}`, valid for ``n_active = n_deriv - 1``);
    ``prior_pars`` is the *blocked* IBM prior ``(d, n_deriv, n_deriv)``.
    Deterministic — no RNG.

    ``ode_expand`` accepts an optional runtime ``kappa`` keyword (defaulting
    to the build-time value) so ``magi_logdens(..., kappa=k)`` is
    differentiable w.r.t. the diffusivity at a fixed path — the MAGI
    parameter-inference dial in the large-state regime.

    The defaults (``n_steps=25``, ``prior_sigma=0.02``) are the *float32-
    valid* MAGI regime, deliberately unlike the solver fixtures (N=1000,
    diffuse prior): with exact pseudo-observations the level-innovation
    scale is :math:`\\sigma\\,\\Delta t^{p-1/2}`, which must stay well above
    the float32 representation noise of the path
    (:math:`\\varepsilon\\,\\|u\\| \\approx 6\\times10^{-8}`) for the density
    to carry information in float32 — a fine grid or diffuse-σ config
    silently destroys the κ signal.  MAGI's
    whole point is coarse grids, so this costs nothing.
    """
    if n_active != n_deriv - 1:
        raise ValueError("magi_setup's ode_expand requires "
                         "n_active == n_deriv - 1")
    p = n_deriv
    mu1 = -2.0 * (1.0 - np.cos(np.pi / (d + 1))) * float((d + 1) ** 2) \
        * kappa
    u0 = np.sin(np.pi * np.arange(1, d + 1) / (d + 1))
    tgrid = t_min + (t_max - t_min) * np.arange(n_steps + 1) / n_steps
    decay = np.exp(mu1 * (tgrid - t_min))
    # closed form (u0 is a Laplacian eigenvector): d^j u/dt^j = mu1^j u(t)
    u = np.stack([np.outer(decay, u0) * mu1 ** j
                  for j in range(n_active)], axis=-1)
    L0 = jnp.asarray(laplacian(d, 1.0), dtype)

    def ode_expand(usub, kappa=kappa, **params):
        top = kappa * (usub[..., -1] @ L0.T)
        return jnp.concatenate([usub, top[..., None]], axis=-1)

    dt = (t_max - t_min) / n_steps
    prior_pars = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype),
        ibm_init(dt, p, jnp.full((d,), prior_sigma, dtype)))
    return jnp.asarray(u, dtype), ode_expand, prior_pars, dt


def fenrir_setup(d=128, n_deriv=3, n_steps=1000, n_obs=20, obs_sd=0.01,
                 seed=0, dtype=jnp.float32, **setup_kwargs):
    """Parameter-inference configuration for the heat benchmark: the
    :func:`setup` solver arguments plus ``n_obs`` noisy full-state
    observations of the closed-form solution on an even grid, with the
    diffusivity exposed as a ``kappa`` keyword (the inferred parameter).

    Returns ``(kw, kappa0)`` where ``kw`` are keyword arguments for
    :func:`rodeo_tpu.ops.stationary.fenrir_stationary` /
    :func:`rodeo_tpu.ops.precond.fenrir` (pass ``n_deriv=`` and
    ``n_warm=`` separately) and ``kappa0`` is the true diffusivity.
    Deterministic for a given ``seed`` — bench rows and CPU reference
    subprocesses can reproduce the identical problem instance.
    """
    p = n_deriv
    cfg = setup(d=d, n_deriv=p, n_steps=n_steps, dtype=dtype,
                **setup_kwargs)
    exact = cfg.pop("exact")
    cfg.pop("n_deriv")
    t_min, t_max = cfg["t_min"], cfg["t_max"]
    obs_idx = np.linspace(n_steps // n_obs, n_steps, n_obs, dtype=int)
    obs_times = np.asarray(t_min + obs_idx * (t_max - t_min) / n_steps)
    rng = np.random.default_rng(seed)
    y = np.stack([exact(float(t)) for t in obs_times])[:, None, :] \
        + obs_sd * rng.standard_normal((n_obs, 1, d))
    D = np.zeros((n_obs, 1, d, d * p))
    for i in range(d):
        D[:, 0, i, i * p] = 1.0
    L_unit = jnp.asarray(laplacian(d, kappa=1.0), dtype)

    def ode_fun(X_t, t, kappa=KAPPA):
        return (kappa * (L_unit @ X_t[0, ::p]))[None, :]

    from rodeo_tpu.interrogate import interrogate_kramer
    kw = dict(key=None, ode_fun=ode_fun, ode_weight=cfg["ode_weight"],
              ode_init=cfg["ode_init"], t_min=t_min, t_max=t_max,
              n_steps=n_steps, interrogate=interrogate_kramer,
              prior_pars=cfg["prior_pars"],
              obs_data=jnp.asarray(y, dtype), obs_times=obs_times,
              obs_weight=jnp.asarray(D, dtype),
              obs_var=(obs_sd ** 2) * jnp.broadcast_to(
                  jnp.eye(d, dtype=dtype), (n_obs, 1, d, d)))
    return kw, jnp.asarray(KAPPA, dtype)
