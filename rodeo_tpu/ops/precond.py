r"""
Taylor-mode preconditioning of the solver state.

The IBM prior over ``(x, x', ..., x^{(q)})`` with step ``dt`` has transition
and noise matrices whose entries span :math:`dt^{\pm q}` — condition numbers
of :math:`10^{12}` and beyond for fine grids, which overflows float32's
precision and is why the unpreconditioned covariance filter NaNs in f32.

Changing coordinates to :math:`\tilde x = T^{-1} x` with the diagonal

.. math:: T_{ii} = \sqrt{dt} \; dt^{\,q-i} / (q-i)!

renders the prior dt-free: :math:`\tilde Q = T^{-1} Q T` becomes the Pascal
(binomial) matrix and :math:`\tilde R = T^{-1} R T^{-1}` a Hilbert-like
matrix — both with :math:`O(1)` condition.  (Cf. Krämer & Hennig 2020,
*Stable implementation of probabilistic ODE solvers* — the same trick used
by f32-first probabilistic-numerics codes.)

The wrappers below run the existing solvers entirely in scaled coordinates
(diagonal rescaling of inputs, interrogation adapter, diagonal unscaling of
outputs), so the covariance-form filter — the fastest form — becomes
numerically sound in float32.  Quadratic forms like the rodeo interrogation
variance :math:`W \Sigma W'` are invariant under the transform.
"""
import jax
import jax.numpy as jnp

import rodeo_tpu.solve as _solve
from rodeo_tpu.ops import ptime as _ptime
from rodeo_tpu.ops.linalg import fast_linalg

__all__ = ["taylor_scale", "scale_prior", "solve_mv", "solve_sim",
           "solve_mv_iterated", "fenrir", "dalton", "basic", "daltonng",
           "magi_logdens", "fenrir_solve_mv", "dalton_solve_mv",
           "dalton_solve_sim", "dalton_solve_mv_nn"]


def taylor_scale(dt, n_deriv, dtype=None):
    r"""
    Diagonal preconditioner ``t_vec`` with
    ``t_vec[i] = sqrt(dt) * dt**(q-i) / (q-i)!`` for ``q = n_deriv - 1``.

    Built from exact trace-time factorials and iterated ``dt``
    multiplications — not ``pow``/``gammaln`` device transcendentals,
    whose float32 approximations on a device can perturb the scaling by ~1e-4
    relative (see :mod:`rodeo_tpu.prior.ibm`).  Jittable in ``dt``.

    Returns:
        (ndarray(n_deriv,)): The diagonal of :math:`T`.
    """
    import math
    dt = jnp.asarray(dt, dtype) if dtype is not None else jnp.asarray(dt)
    pows = [jnp.ones_like(dt)]
    for _ in range(n_deriv - 1):
        pows.append(pows[-1] * dt)
    q = n_deriv - 1
    return jnp.sqrt(dt) * jnp.stack(
        [pows[q - i] / math.factorial(q - i) for i in range(n_deriv)])


def scale_prior(prior_pars, t_vec, sqrt=False):
    r"""
    Transform prior parameters into scaled coordinates:
    :math:`\tilde Q_{ij} = Q_{ij} t_j / t_i`,
    :math:`\tilde R_{ij} = R_{ij} / (t_i t_j)`.

    With ``sqrt=True`` the ``prior_var`` entry is a square-root *factor*
    :math:`R_f` (the square-root Kalman convention): the factor of
    :math:`T^{-1} R_f R_f' T^{-1}` is the row-scaled :math:`T^{-1} R_f`.

    Entrywise diagonal scaling — exact (no cancellation), so it restores
    conditioning even if the input was computed in low precision.
    """
    prior_weight, prior_var = prior_pars
    t = t_vec.astype(prior_weight.dtype)
    Qs = prior_weight * (t[None, :] / t[:, None])
    if sqrt:
        Rs = prior_var / t[:, None]
    else:
        Rs = prior_var / (t[:, None] * t[None, :])
    return Qs, Rs


def _wrap_interrogate(interrogate, ode_weight_orig, t_vec, sqrt=False):
    """Adapter: scaled-coordinate solver state <-> user-space interrogation.

    The solver hands over scaled predicted moments and the scaled weight
    matrix; the user's interrogation runs on original coordinates and its
    returned ``wgt_meas`` is scaled back.  ``sqrt=True`` when the solver
    runs the square-root backend (``var_state_pred`` is then a factor,
    unscaled by row only — matching what the unpreconditioned sqrt solver
    would hand the interrogation).
    """

    def wrapped(key, ode_fun, ode_weight, t, mean_state_pred,
                var_state_pred, **params):
        t_v = t_vec.astype(mean_state_pred.dtype)
        mean_orig = mean_state_pred * t_v
        # guard against float32 overflow through the user ODE's polynomial
        # terms during divergent *transient* sweeps of the iterated
        # parallel solver — never binds for a sane converged trajectory
        if mean_orig.dtype == jnp.float32:
            mean_orig = jnp.clip(jnp.nan_to_num(mean_orig), -1e10, 1e10)
        if sqrt:
            var_orig = var_state_pred * t_v[:, None]
        else:
            var_orig = var_state_pred * (t_v[:, None] * t_v[None, :])
        wgt_meas, mean_meas, var_meas = interrogate(
            key=key, ode_fun=ode_fun, ode_weight=ode_weight_orig, t=t,
            mean_state_pred=mean_orig, var_state_pred=var_orig, **params)
        return wgt_meas * t_v, mean_meas, var_meas

    return wrapped


def _scaled_inputs(ode_weight, ode_init, prior_pars, t_min, t_max, n_steps,
                   n_deriv=None, sqrt=False):
    """``n_deriv=None``: blocked layout, the whole trailing state dim is
    one variable's derivatives.  With ``n_deriv`` given, the state is the
    dense/non-blocked layout (``indep_init``) — ``n_vars`` blocks of
    ``n_deriv`` derivatives concatenated — and the per-derivative Taylor
    scaling tiles across variables."""
    state_dim = ode_init.shape[-1]
    if n_deriv is None:
        n_deriv = state_dim
    dt = (t_max - t_min) / n_steps
    t_vec = taylor_scale(dt, n_deriv, dtype=ode_init.dtype)
    if n_deriv != state_dim:
        if state_dim % n_deriv:
            raise ValueError(
                f"n_deriv={n_deriv} must divide the state dimension "
                f"{state_dim} (dense layout = n_vars blocks of n_deriv "
                f"derivatives)")
        t_vec = jnp.tile(t_vec, state_dim // n_deriv)
    return (
        t_vec,
        ode_weight * t_vec[None, None, :].astype(ode_weight.dtype),
        ode_init / t_vec.astype(ode_init.dtype),
        scale_prior(prior_pars, t_vec, sqrt=sqrt),
    )


def solve_mv(key, ode_fun, ode_weight, ode_init,
             t_min, t_max, n_steps,
             interrogate,
             prior_pars,
             kalman_type="standard", temporal="sequential", n_deriv=None,
             **params):
    r"""
    Preconditioned :func:`rodeo_tpu.solve.solve_mv`: identical posterior (up
    to fp), but the filter/smoother run in Taylor-scaled coordinates — use
    this in float32 (the covariance form NaNs otherwise once the
    prior's dynamic range exceeds ~1e7).

    Same signature and return contract as :func:`rodeo_tpu.solve.solve_mv`.
    ``n_deriv``: pass the per-variable derivative count when using the
    dense/non-blocked (:func:`rodeo_tpu.prior.indep_init`) state layout so
    the Taylor scaling tiles across variables.
    """
    t_vec, W_s, x0_s, prior_s = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps, n_deriv,
        sqrt=(kalman_type == "square-root"))
    with fast_linalg():
        mean_s, var_s = _solve.solve_mv(
            key=key, ode_fun=ode_fun, ode_weight=W_s, ode_init=x0_s,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            interrogate=_wrap_interrogate(
                interrogate, ode_weight, t_vec,
                sqrt=(kalman_type == "square-root")),
            prior_pars=prior_s, kalman_type=kalman_type, temporal=temporal,
            **params)
    t_v = t_vec.astype(mean_s.dtype)
    if kalman_type == "square-root":
        var_out = var_s * t_v[:, None]
    else:
        var_out = var_s * (t_v[:, None] * t_v[None, :])
    return mean_s * t_v, var_out


def solve_sim(key, ode_fun, ode_weight, ode_init,
              t_min, t_max, n_steps,
              interrogate,
              prior_pars,
              kalman_type="standard", n_deriv=None, **params):
    r"""
    Preconditioned :func:`rodeo_tpu.solve.solve_sim` (see :func:`solve_mv`;
    ``n_deriv`` selects the dense/non-blocked scaling as there).
    """
    t_vec, W_s, x0_s, prior_s = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps, n_deriv,
        sqrt=(kalman_type == "square-root"))
    with fast_linalg():
        xs = _solve.solve_sim(
            key=key, ode_fun=ode_fun, ode_weight=W_s, ode_init=x0_s,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            interrogate=_wrap_interrogate(
                interrogate, ode_weight, t_vec,
                sqrt=(kalman_type == "square-root")),
            prior_pars=prior_s, kalman_type=kalman_type, **params)
    return xs * t_vec.astype(xs.dtype)


def fenrir(key, ode_fun, ode_weight, ode_init,
           t_min, t_max, n_steps,
           interrogate,
           prior_pars,
           obs_data, obs_times, obs_weight, obs_var,
           kalman_type="standard", temporal="sequential", n_deriv=None,
           **params):
    r"""
    Preconditioned :func:`rodeo_tpu.inference.fenrir.fenrir`.
    ``n_deriv`` selects the dense/non-blocked (large-state) scaling as in
    :func:`solve_mv`.

    The observation model transforms as :math:`\tilde D = D T`; the
    log-density of the Y-space observations is invariant under the state
    coordinate change, so this returns the same value as the plain
    implementation — but float32-stable.  ``temporal="parallel"``
    runs the backward pass as a parallel-in-time associative scan.
    """
    from rodeo_tpu.inference import fenrir as _fenrir_fn
    t_vec, W_s, x0_s, prior_s = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps, n_deriv,
        sqrt=(kalman_type == "square-root"))
    obs_weight_s = obs_weight * t_vec.astype(obs_weight.dtype)
    with fast_linalg():
        return _fenrir_fn(
            key=key, ode_fun=ode_fun, ode_weight=W_s, ode_init=x0_s,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            interrogate=_wrap_interrogate(
                interrogate, ode_weight, t_vec,
                sqrt=(kalman_type == "square-root")),
            prior_pars=prior_s,
            obs_data=obs_data, obs_times=obs_times,
            obs_weight=obs_weight_s, obs_var=obs_var,
            kalman_type=kalman_type, temporal=temporal, **params)


def dalton(key, ode_fun, ode_weight, ode_init,
           t_min, t_max, n_steps,
           interrogate,
           prior_pars,
           obs_data, obs_times, obs_weight, obs_var,
           n_deriv=None, **params):
    r"""
    Preconditioned :func:`rodeo_tpu.inference.dalton.dalton`
    (see :func:`fenrir`).
    """
    from rodeo_tpu.inference import dalton as _dalton_fn
    t_vec, W_s, x0_s, prior_s = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps, n_deriv)
    obs_weight_s = obs_weight * t_vec.astype(obs_weight.dtype)
    with fast_linalg():
        return _dalton_fn(
            key=key, ode_fun=ode_fun, ode_weight=W_s, ode_init=x0_s,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            interrogate=_wrap_interrogate(interrogate, ode_weight, t_vec),
            prior_pars=prior_s,
            obs_data=obs_data, obs_times=obs_times,
            obs_weight=obs_weight_s, obs_var=obs_var, **params)


def basic(key, ode_fun, ode_weight, ode_init,
          t_min, t_max, n_steps,
          interrogate,
          prior_pars,
          obs_data, obs_times, obs_loglik,
          n_deriv=None, **params):
    r"""
    Preconditioned :func:`rodeo_tpu.inference.basic.basic`: the solve runs
    in Taylor-scaled coordinates (f32-stable) and the user observation
    log-likelihood is evaluated on the unscaled solution, so the value
    matches the plain implementation.  ``n_deriv`` selects the
    dense/non-blocked (large-state) scaling as in :func:`solve_mv`.
    """
    import jax.numpy as _jnp
    Xt, _ = solve_mv(
        key=key, ode_fun=ode_fun, ode_weight=ode_weight,
        ode_init=ode_init, t_min=t_min, t_max=t_max, n_steps=n_steps,
        interrogate=interrogate, prior_pars=prior_pars, n_deriv=n_deriv,
        **params)
    sim_times = _jnp.linspace(t_min, t_max, n_steps + 1)
    ode_data = Xt[_jnp.searchsorted(sim_times, obs_times)]
    return obs_loglik(obs_data, ode_data, **params), Xt


def _wrap_obs_loglik(obs_loglik_i, t_vec):
    """Adapter so a user observation log-likelihood written for original
    coordinates sees the unscaled state (its gradient/Hessian then
    linearize w.r.t. the scaled state by the chain rule automatically)."""

    def wrapped(obs_i, state_scaled, i, **params):
        return obs_loglik_i(obs_i, state_scaled * t_vec.astype(
            state_scaled.dtype), i, **params)

    return wrapped


def daltonng(key, ode_fun, ode_weight, ode_init,
             t_min, t_max, n_steps,
             interrogate,
             prior_pars,
             obs_data, obs_times, obs_loglik_i,
             n_deriv=None, **params):
    r"""
    Preconditioned :func:`rodeo_tpu.inference.dalton.daltonng` (non-Gaussian
    DALTON).  The two state-path log-densities (``logx_z`` and
    ``logx_yhat``) each pick up the same coordinate-change Jacobian, which
    cancels in the assembled value ``logy_x + logx_z - logx_yhat``, so
    the result matches the plain implementation (the Laplace linearization
    is chain-ruled through the scaling by :func:`_wrap_obs_loglik`).
    """
    from rodeo_tpu.inference import daltonng as _daltonng_fn
    t_vec, W_s, x0_s, prior_s = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps, n_deriv)
    with fast_linalg():
        return _daltonng_fn(
            key=key, ode_fun=ode_fun, ode_weight=W_s, ode_init=x0_s,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            interrogate=_wrap_interrogate(interrogate, ode_weight, t_vec),
            prior_pars=prior_s,
            obs_data=obs_data, obs_times=obs_times,
            obs_loglik_i=_wrap_obs_loglik(obs_loglik_i, t_vec), **params)


def magi_logdens(ode_data_subset, ode_expand, n_active, prior_pars, dt,
                 kalman_type="standard", **params):
    r"""
    Preconditioned :func:`rodeo_tpu.inference.magi.magi_logdens`.

    The MAGI filter runs on the Taylor-scaled state; since the observed
    pseudo-data are the scaled first ``n_active`` derivatives, the scaled
    log-density differs from the original by the exact change-of-variables
    Jacobian :math:`N\,n_{block}\sum_{i<n_{active}}\log t_i`, which is
    added back — so the value matches the plain implementation, but stays
    finite in float32.

    Args:
        dt (float): Solver step size (needed to build the Taylor scaling;
            the plain API encodes it only implicitly in ``prior_pars``).
        (other arguments as :func:`rodeo_tpu.inference.magi.magi_logdens`)
    """
    from rodeo_tpu.inference import magi_logdens as _magi_fn
    probe = ode_expand(ode_data_subset, **params)
    n_steps_p1, n_block, n_deriv = probe.shape
    dtype = probe.dtype
    t_vec = taylor_scale(dt, n_deriv, dtype=dtype)
    prior_s = scale_prior(prior_pars, t_vec)

    def ode_expand_s(subset, **p):
        return ode_expand(subset, **p) / t_vec.astype(dtype)

    with fast_linalg():
        logdens_s = _magi_fn(
            ode_data_subset=ode_data_subset, ode_expand=ode_expand_s,
            n_active=n_active, prior_pars=prior_s,
            kalman_type=kalman_type, **params)
    n_terms = n_steps_p1 - 1
    jacobian = n_terms * n_block * jnp.sum(jnp.log(t_vec[:n_active]))
    return logdens_s - jacobian


def fenrir_solve_mv(key, ode_fun, ode_weight, ode_init,
                    t_min, t_max, n_steps,
                    interrogate,
                    prior_pars,
                    obs_data, obs_times, obs_weight, obs_var,
                    temporal="sequential", n_deriv=None, **params):
    r"""
    Preconditioned :func:`rodeo_tpu.inference.fenrir.solve_mv`
    (data-conditioned posterior; unscaled moments returned).
    """
    import importlib
    _fenrir_mod = importlib.import_module("rodeo_tpu.inference.fenrir")
    t_vec, W_s, x0_s, prior_s = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps, n_deriv)
    obs_weight_s = obs_weight * t_vec.astype(obs_weight.dtype)
    # NB: no fast_linalg here — the final smoothing pass runs over the
    # *backward* chain, whose predicted variances become numerically
    # singular near the exact-init end (C_0 = 0); the closed-form
    # determinant inverse explodes there, while the factorization-based
    # solve stays bounded.  This reconstruction is not a hot path.
    mean_s, var_s = _fenrir_mod.solve_mv(
        key=key, ode_fun=ode_fun, ode_weight=W_s, ode_init=x0_s,
        t_min=t_min, t_max=t_max, n_steps=n_steps,
        interrogate=_wrap_interrogate(interrogate, ode_weight, t_vec),
        prior_pars=prior_s,
        obs_data=obs_data, obs_times=obs_times,
        obs_weight=obs_weight_s, obs_var=obs_var,
        temporal=temporal, **params)
    t_v = t_vec.astype(mean_s.dtype)
    return mean_s * t_v, var_s * (t_v[:, None] * t_v[None, :])


def _dalton_mod():
    import importlib
    return importlib.import_module("rodeo_tpu.inference.dalton")


def dalton_solve_mv(key, ode_fun, ode_weight, ode_init,
                    t_min, t_max, n_steps,
                    interrogate,
                    prior_pars,
                    obs_data, obs_times, obs_weight, obs_var,
                    n_deriv=None, **params):
    r"""
    Preconditioned :func:`rodeo_tpu.inference.dalton.solve_mv`.
    """
    t_vec, W_s, x0_s, prior_s = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps, n_deriv)
    obs_weight_s = obs_weight * t_vec.astype(obs_weight.dtype)
    with fast_linalg():
        mean_s, var_s = _dalton_mod().solve_mv(
            key=key, ode_fun=ode_fun, ode_weight=W_s, ode_init=x0_s,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            interrogate=_wrap_interrogate(interrogate, ode_weight, t_vec),
            prior_pars=prior_s,
            obs_data=obs_data, obs_times=obs_times,
            obs_weight=obs_weight_s, obs_var=obs_var, **params)
    t_v = t_vec.astype(mean_s.dtype)
    return mean_s * t_v, var_s * (t_v[:, None] * t_v[None, :])


def dalton_solve_sim(key, ode_fun, ode_weight, ode_init,
                     t_min, t_max, n_steps,
                     interrogate,
                     prior_pars,
                     obs_data, obs_times, obs_weight, obs_var,
                     n_deriv=None, **params):
    r"""
    Preconditioned :func:`rodeo_tpu.inference.dalton.solve_sim`.
    """
    t_vec, W_s, x0_s, prior_s = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps, n_deriv)
    obs_weight_s = obs_weight * t_vec.astype(obs_weight.dtype)
    with fast_linalg():
        xs = _dalton_mod().solve_sim(
            key=key, ode_fun=ode_fun, ode_weight=W_s, ode_init=x0_s,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            interrogate=_wrap_interrogate(interrogate, ode_weight, t_vec),
            prior_pars=prior_s,
            obs_data=obs_data, obs_times=obs_times,
            obs_weight=obs_weight_s, obs_var=obs_var, **params)
    return xs * t_vec.astype(xs.dtype)


def dalton_solve_mv_nn(key, ode_fun, ode_weight, ode_init,
                       t_min, t_max, n_steps,
                       interrogate,
                       prior_pars,
                       obs_data, obs_times, obs_loglik_i,
                       n_deriv=None, **params):
    r"""
    Preconditioned :func:`rodeo_tpu.inference.dalton.solve_mv_nn`
    (non-Gaussian data-conditioned posterior).
    """
    t_vec, W_s, x0_s, prior_s = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps, n_deriv)
    with fast_linalg():
        mean_s, var_s = _dalton_mod().solve_mv_nn(
            key=key, ode_fun=ode_fun, ode_weight=W_s, ode_init=x0_s,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            interrogate=_wrap_interrogate(interrogate, ode_weight, t_vec),
            prior_pars=prior_s,
            obs_data=obs_data, obs_times=obs_times,
            obs_loglik_i=_wrap_obs_loglik(obs_loglik_i, t_vec), **params)
    t_v = t_vec.astype(mean_s.dtype)
    return mean_s * t_v, var_s * (t_v[:, None] * t_v[None, :])


def solve_mv_iterated(key, ode_fun, ode_weight, ode_init,
                      t_min, t_max, n_steps,
                      interrogate,
                      prior_pars,
                      **kwargs):
    r"""
    Preconditioned :func:`rodeo_tpu.ops.ptime.solve_mv_iterated` — the fully
    parallel-in-time engine in Taylor-scaled coordinates (required for f32).

    Extra keyword arguments (``n_iter``, ``warm_start``, ``n_coarse``,
    ``window_size``) pass through.
    """
    t_vec, W_s, x0_s, prior_s = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps,
        kwargs.pop("n_deriv", None))
    with fast_linalg():
        mean_s, var_s = _ptime.solve_mv_iterated(
            key=key, ode_fun=ode_fun, ode_weight=W_s, ode_init=x0_s,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            interrogate=_wrap_interrogate(interrogate, ode_weight, t_vec),
            prior_pars=prior_s, **kwargs)
    t_v = t_vec.astype(mean_s.dtype)
    return mean_s * t_v, var_s * (t_v[:, None] * t_v[None, :])
