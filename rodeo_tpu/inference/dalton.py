r"""
DALTON data-adaptive likelihood approximation.

Computes :math:`p(Y_{0:M} \mid Z_{1:N}) = p(Y_{0:M}, Z_{1:N}) / p(Z_{1:N})`
by running two Kalman filters in one scan: a *joint* filter whose measurement
stacks the ODE interrogation rows with the observation rows, and a *marginal*
ODE-only filter.  For non-Gaussian observations, each observation is
Laplace-linearized (gradient + Hessian of its log-likelihood) into a Gaussian
pseudo-observation.

Functional parity target: ``/root/reference/src/rodeo/inference/dalton.py``
(``dalton``, ``daltonng``, ``solve_mv``, ``solve_sim``, ``solve_mv_nn`` and
private helpers).  Known reference bug fixed here: ``dalton.py:430`` passes
``var_State=`` (typo) to ``smooth_mv``, which breaks the square-root backend;
this implementation passes ``var_state=`` correctly.
"""

import jax
import jax.numpy as jnp
import jax.scipy as jsp

from rodeo_tpu.kalmantv import get_backend
from rodeo_tpu.inference.fenrir import _forecast_update, _obs_grid
from rodeo_tpu.utils import multivariate_normal_logpdf, mvdot, quadform
from rodeo_tpu.solve import _solve_filter as _solve_filter_ode
from rodeo_tpu.ops.scan import scan as _uscan
from rodeo_tpu.ops.linalg import full_matmul_precision

__all__ = ["dalton", "daltonng", "solve_mv", "solve_sim", "solve_mv_nn"]


def _block_diag2(var_a, var_b):
    """Batched 2-matrix block diagonal over a leading block axis."""
    return jax.vmap(jsp.linalg.block_diag)(var_a, var_b)


# --- loglikelihood -----------------------------------------------------------


@full_matmul_precision
def dalton(key, ode_fun, ode_weight, ode_init,
           t_min, t_max, n_steps,
           interrogate,
           prior_pars,
           obs_data, obs_times, obs_weight, obs_var,
           kalman_type="standard", **params):
    r"""
    DALTON marginal log-likelihood for Gaussian observations,
    :math:`\log p(Y_{0:M} \mid Z_{1:N})`.

    Parity: ``dalton.py:39-235``.

    Args:
        key (PRNGKey): PRNG key.
        ode_fun (Callable): Block-form ODE function.
        ode_weight (ndarray(n_block, n_bmeas, n_bstate)): :math:`W`.
        ode_init (ndarray(n_block, n_bstate)): Initial state.
        t_min, t_max (float): Solution interval.
        n_steps (int): Number of solver steps.
        interrogate (Callable): Interrogation scheme.
        prior_pars (tuple): ``(prior_weight, prior_var)``.
        obs_data (ndarray(n_obs, n_block, n_bobs)): Observations.
        obs_times (ndarray(n_obs)): Observation times.
        obs_weight (ndarray(n_obs, n_block, n_bobs, n_bstate)): :math:`D_m`.
        obs_var (ndarray(n_obs, n_block, n_bobs, n_bobs)): :math:`\Omega_m`.
        kalman_type (str): ``"standard"`` or ``"square-root"``.
        params: Optional model parameters.

    Returns:
        (float): The log-likelihood value.
    """
    n_block, n_bmeas, n_bstate = ode_weight.shape
    n_bobs = obs_weight.shape[2]
    kalman_funs = get_backend(kalman_type)
    prior_weight, prior_var = prior_pars

    if kalman_type == "standard":
        return _dalton_dense(
            key=key, ode_fun=ode_fun, ode_weight=ode_weight,
            ode_init=ode_init, t_min=t_min, t_max=t_max, n_steps=n_steps,
            interrogate=interrogate, prior_weight=prior_weight,
            prior_var=prior_var, obs_data=obs_data, obs_times=obs_times,
            obs_weight=obs_weight, obs_var=obs_var,
            kalman_funs=kalman_funs, **params)

    sim_times = jnp.linspace(t_min, t_max, n_steps + 1)
    obs_ind = jnp.searchsorted(sim_times, obs_times)

    dtype = ode_init.dtype
    x_meas = jnp.zeros((n_block, n_bmeas), dtype=dtype)
    obs_mean = jnp.zeros((n_block, n_bobs), dtype=dtype)
    mean_state = jnp.zeros((n_block, n_bstate), dtype=dtype)
    mean_state_init = ode_init
    var_state_init = jnp.zeros((n_block, n_bstate, n_bstate), dtype=dtype)

    def scan(carry, step):
        mean_state_filt_zy, var_state_filt_zy = carry["state_filt_joint"]
        mean_state_filt_z, var_state_filt_z = carry["state_filt_marg"]
        logdens_zy = carry["logdens_joint"]
        logdens_z = carry["logdens_marg"]
        t = step["t"]
        keys = step["key"]
        i = carry["i"]
        ode_time = t_min + (t_max - t_min) * (t + 1) / n_steps

        # --- joint filter p(Z, Y) ---
        mean_state_pred_zy, var_state_pred_zy = kalman_funs.predict(
            mean_state_past=mean_state_filt_zy,
            var_state_past=var_state_filt_zy,
            mean_state=mean_state,
            wgt_state=prior_weight,
            var_state=prior_var,
        )
        wgt_meas, mean_meas, var_meas = interrogate(
            key=keys[0],
            ode_fun=ode_fun,
            ode_weight=ode_weight,
            t=ode_time,
            mean_state_pred=mean_state_pred_zy,
            var_state_pred=var_state_pred_zy,
            **params,
        )
        W_meas = ode_weight + wgt_meas

        def zy_update():
            wgt_meas_obs = jnp.concatenate([W_meas, obs_weight[i]], axis=1)
            mean_meas_obs = jnp.concatenate([mean_meas, obs_mean], axis=1)
            var_meas_obs = _block_diag2(var_meas, obs_var[i])
            x_meas_obs = jnp.concatenate([x_meas, obs_data[i]], axis=1)
            logp, mean_state_next, var_state_next = _forecast_update(
                mean_state_pred=mean_state_pred_zy,
                var_state_pred=var_state_pred_zy,
                x_meas=x_meas_obs,
                mean_meas=mean_meas_obs,
                wgt_meas=wgt_meas_obs,
                var_meas=var_meas_obs,
                kalman_funs=kalman_funs,
            )
            return mean_state_next, var_state_next, logp, i + 1

        def z_update():
            logp, mean_state_next, var_state_next = _forecast_update(
                mean_state_pred=mean_state_pred_zy,
                var_state_pred=var_state_pred_zy,
                x_meas=x_meas,
                mean_meas=mean_meas,
                wgt_meas=W_meas,
                var_meas=var_meas,
                kalman_funs=kalman_funs,
            )
            return mean_state_next, var_state_next, logp, i

        mean_state_next_zy, var_state_next_zy, logp, i = jax.lax.cond(
            t + 1 == obs_ind[i], zy_update, z_update)
        logdens_zy += logp

        # --- marginal filter p(Z) ---
        mean_state_pred_z, var_state_pred_z = kalman_funs.predict(
            mean_state_past=mean_state_filt_z,
            var_state_past=var_state_filt_z,
            mean_state=mean_state,
            wgt_state=prior_weight,
            var_state=prior_var,
        )
        wgt_meas, mean_meas, var_meas = interrogate(
            key=keys[1],
            ode_fun=ode_fun,
            ode_weight=ode_weight,
            t=ode_time,
            mean_state_pred=mean_state_pred_z,
            var_state_pred=var_state_pred_z,
            **params,
        )
        W_meas = ode_weight + wgt_meas
        logp, mean_state_next_z, var_state_next_z = _forecast_update(
            mean_state_pred=mean_state_pred_z,
            var_state_pred=var_state_pred_z,
            x_meas=x_meas,
            mean_meas=mean_meas,
            wgt_meas=W_meas,
            var_meas=var_meas,
            kalman_funs=kalman_funs,
        )
        logdens_z += logp

        carry = {
            "state_filt_joint": (mean_state_next_zy, var_state_next_zy),
            "state_filt_marg": (mean_state_next_z, var_state_next_z),
            "logdens_joint": logdens_zy,
            "logdens_marg": logdens_z,
            "i": i,
        }
        return carry, None

    # log-density of p(Y_0 | X_0) if an observation sits at t = 0
    def _logy0():
        mean_y0 = mvdot(obs_weight[0], ode_init) + obs_mean
        logdens_zy = jnp.sum(multivariate_normal_logpdf(
            obs_data[0], mean=mean_y0, cov=obs_var[0]))
        return logdens_zy.astype(ode_init.dtype), 1

    def _no_logy0():
        return jnp.zeros((), dtype=ode_init.dtype), 0

    logdens_zy, i = jax.lax.cond(obs_ind[0] == 0, _logy0, _no_logy0)

    scan_init = {
        "state_filt_joint": (mean_state_init, var_state_init),
        "state_filt_marg": (mean_state_init, var_state_init),
        "logdens_joint": logdens_zy,
        "logdens_marg": jnp.zeros((), dtype=ode_init.dtype),
        "i": i,
    }
    if key is not None:
        keys = jax.random.split(key, num=(n_steps, 2))
    else:
        keys = jnp.zeros((n_steps, 2))
    steps = {"t": jnp.arange(n_steps), "key": keys}
    out, _ = _uscan(scan, scan_init, steps)
    return out["logdens_joint"] - out["logdens_marg"]


def _dalton_dense(key, ode_fun, ode_weight, ode_init,
                  t_min, t_max, n_steps,
                  interrogate,
                  prior_weight, prior_var,
                  obs_data, obs_times, obs_weight, obs_var,
                  kalman_funs, **params):
    """:func:`_dalton_dense_parts` difference — see there for the design."""
    logdens_zy, logdens_z = _dalton_dense_parts(
        key=key, ode_fun=ode_fun, ode_weight=ode_weight, ode_init=ode_init,
        t_min=t_min, t_max=t_max, n_steps=n_steps, interrogate=interrogate,
        prior_weight=prior_weight, prior_var=prior_var, obs_data=obs_data,
        obs_times=obs_times, obs_weight=obs_weight, obs_var=obs_var,
        kalman_funs=kalman_funs, **params)
    return logdens_zy - logdens_z


def _dalton_dense_parts(key, ode_fun, ode_weight, ode_init,
                        t_min, t_max, n_steps,
                        interrogate,
                        prior_weight, prior_var,
                        obs_data, obs_times, obs_weight, obs_var,
                        kalman_funs, **params):
    r"""
    Masked-dense DALTON joint/marginal log-densities ``(log p(Z, Y),
    log p(Z))`` (standard form): the observation model
    is grid-scattered (:func:`rodeo_tpu.inference.fenrir._obs_grid`), so
    the single scan has no ``lax.cond`` branches (which execute both
    sides under ``vmap``) and no observation index carry.

    The joint filter's *state update* processes its two measurement
    groups **sequentially** (ODE pseudo-observation update, then the
    observation update), which is algebraically identical to the
    reference's stacked ``[W_meas; D]`` joint update because the joint
    measurement noise is block-diagonal (chain rule) — but float32-robust
    where the stacked form is not: the stacked innovation covariance
    pairs the ODE row (variance :math:`W \Sigma W' \sim \sigma^2
    \Delta t^{2q-1}`, huge under a diffuse prior) with a unit dead row
    (or a small :math:`\Omega_m` at observation rows), a ~1e10-condition
    2x2 system whose f32 closed-form solve injects noise into the joint
    state *every step*.  Sequential processing makes the dead-row
    observation update an exact bitwise identity (zero weight rows =>
    exactly-zero gain, Joseph form multiplies by an exact identity).
    This matches the fused Pallas kernel
    (``rodeo_tpu/ops/pallas_dalton.py``), which processes measurements
    sequentially for the same reason.

    The *log-density* factor follows the reference's branch structure
    exactly but without branches: at observation steps the stacked
    eigen-masked logpdf of the joint forecast (upstream's obs branch,
    ``dalton.py:137-163``), at the other steps the plain ODE forecast
    logpdf (upstream's no-obs branch) — ``where``-selected per step.
    See the in-function comment for why the earlier
    dead-row-stacking + constant-cancellation trick was an f32 cliff.

    Measured f32 drift vs the f64 reference on Lorenz63-4k (21 obs):
    11,286 absolute with the stacked update + dead-row-stacked density;
    21.7 (1.6e-4 relative) with this formulation plus the
    determinant-significance eigen mask in
    :func:`rodeo_tpu.utils.multivariate_normal_logpdf`; the marginal
    filter alone sits at 1.6.  Values match the branched reference
    algorithm (``/root/reference/src/rodeo/inference/dalton.py:39-235``)
    to fp rounding (1e-8 in f64, pinned by tests/test_parity_reference.py).
    """
    n_block, n_bmeas, n_bstate = ode_weight.shape
    n_bobs = obs_weight.shape[2]
    dtype = ode_init.dtype

    d_grid, y_grid, om_grid, mask = _obs_grid(
        t_min, t_max, n_steps, obs_data, obs_times, obs_weight, obs_var,
        dtype)
    x_meas = jnp.zeros((n_block, n_bmeas), dtype=dtype)
    obs_mean = jnp.zeros((n_block, n_bobs), dtype=dtype)
    mean_state = jnp.zeros((n_block, n_bstate), dtype=dtype)
    var_state_init = jnp.zeros((n_block, n_bstate, n_bstate), dtype=dtype)

    def scan(carry, xs):
        mean_filt_zy, var_filt_zy = carry["state_filt_joint"]
        mean_filt_z, var_filt_z = carry["state_filt_marg"]
        ode_time = t_min + (t_max - t_min) * (xs["t"] + 1) / n_steps

        # --- joint filter p(Z, Y): sequential measurement processing ---
        # (ODE pseudo-observation update, then the observation update;
        # see the docstring for why this replaces the stacked update)
        mean_pred_zy, var_pred_zy = kalman_funs.predict(
            mean_state_past=mean_filt_zy,
            var_state_past=var_filt_zy,
            mean_state=mean_state,
            wgt_state=prior_weight,
            var_state=prior_var,
        )
        wgt_meas, mean_meas, var_meas = interrogate(
            key=xs["key"][0],
            ode_fun=ode_fun,
            ode_weight=ode_weight,
            t=ode_time,
            mean_state_pred=mean_pred_zy,
            var_state_pred=var_pred_zy,
            **params,
        )
        wgt_ode = ode_weight + wgt_meas
        mean_mid_zy, var_mid_zy = kalman_funs.update(
            mean_state_pred=mean_pred_zy,
            var_state_pred=var_pred_zy,
            x_meas=x_meas,
            mean_meas=mean_meas,
            wgt_meas=wgt_ode,
            var_meas=var_meas,
        )
        # masked observation update: zero weight rows at non-observation
        # steps give an exactly-zero gain (bitwise identity update)
        mean_next_zy, var_next_zy = kalman_funs.update(
            mean_state_pred=mean_mid_zy,
            var_state_pred=var_mid_zy,
            x_meas=xs["y"],
            mean_meas=obs_mean,
            wgt_meas=xs["D"],
            var_meas=xs["Om"],
        )
        # the log-density factor keeps the reference's STACKED forecast
        # moments (eigen-masked logpdf over the joint forecast at
        # observation steps — the sequential chain-rule factorization
        # would not reproduce upstream's joint-spectrum masking; measured
        # 8.5 absolute deviation on the FitzHugh parity fixture).  Only
        # the state update runs sequentially — that is where the stacked
        # form's ~1e10-condition solve poisons float32.  The per-step
        # obs/no-obs density selection happens after the scan.
        wgt_stack = jnp.concatenate([wgt_ode, xs["D"]], axis=1)
        mean_stack = jnp.concatenate([mean_meas, obs_mean], axis=1)
        var_stack = _block_diag2(var_meas, xs["Om"])
        x_stack = jnp.concatenate([x_meas, xs["y"]], axis=1)
        fore_mean_zy = mvdot(wgt_stack, mean_pred_zy) + mean_stack
        fore_var_zy = quadform(wgt_stack, var_pred_zy) + var_stack

        # --- marginal filter p(Z) ---
        mean_pred_z, var_pred_z = kalman_funs.predict(
            mean_state_past=mean_filt_z,
            var_state_past=var_filt_z,
            mean_state=mean_state,
            wgt_state=prior_weight,
            var_state=prior_var,
        )
        wgt_meas, mean_meas, var_meas = interrogate(
            key=xs["key"][1],
            ode_fun=ode_fun,
            ode_weight=ode_weight,
            t=ode_time,
            mean_state_pred=mean_pred_z,
            var_state_pred=var_pred_z,
            **params,
        )
        W_meas = ode_weight + wgt_meas
        mean_next_z, var_next_z = kalman_funs.update(
            mean_state_pred=mean_pred_z,
            var_state_pred=var_pred_z,
            x_meas=x_meas,
            mean_meas=mean_meas,
            wgt_meas=W_meas,
            var_meas=var_meas,
        )
        fore_mean_z = mvdot(W_meas, mean_pred_z) + mean_meas
        fore_var_z = quadform(W_meas, var_pred_z) + var_meas

        carry = {
            "state_filt_joint": (mean_next_zy, var_next_zy),
            "state_filt_marg": (mean_next_z, var_next_z),
        }
        stack = {
            "x_stack": x_stack,
            "fore_mean_zy": fore_mean_zy, "fore_var_zy": fore_var_zy,
            "fore_mean_z": fore_mean_z, "fore_var_z": fore_var_z,
        }
        return carry, stack

    scan_init = {
        "state_filt_joint": (ode_init, var_state_init),
        "state_filt_marg": (ode_init, var_state_init),
    }
    if key is not None:
        keys = jax.random.split(key, num=(n_steps, 2))
    else:
        keys = jnp.zeros((n_steps, 2))
    xs = {
        "t": jnp.arange(n_steps), "key": keys,
        "D": d_grid[1:], "y": y_grid[1:], "Om": om_grid[1:],
    }
    _, stack = _uscan(scan, scan_init, xs)

    # log-density of p(Y_0 | X_0) if an observation sits at t = 0.
    # NB: keep the eigen-MASKED logpdf (not the closed-form fast one) on
    # the density factors that can be degenerate: with zero-noise
    # interrogations the ODE forecast covariance can be numerically
    # singular, and upstream's semantic is to DROP those directions from
    # both the joint and the marginal density; a closed-form logdet keeps
    # them and shifts the assembled value.
    logpdf = multivariate_normal_logpdf
    logp0 = jnp.sum(logpdf(
        y_grid[0], mean=mvdot(d_grid[0], ode_init) + obs_mean,
        cov=om_grid[0]))
    # joint: at OBSERVATION steps the reference stacks the ODE and
    # observation rows and takes the eigen-masked logpdf of the joint
    # forecast (dalton.py:137-163) — keep that exactly.  At NO-obs steps
    # the reference's `lax.cond` branch evaluates the plain ODE forecast
    # logpdf (dalton.py:168-195 path); evaluate that directly instead of
    # the earlier dead-row-stacking + constant-cancellation trick.  The
    # trick is exact in real arithmetic but an f32 cliff: appending a
    # unit dead row raises the stacked spectrum's scale to 1, so the
    # logpdf's dtype-relative eigenvalue mask (100*eps*wmax,
    # utils.py:_mvn_logpdf_pieces) drops the genuine ~1e-10 ODE direction
    # that f64 keeps — measured 11,286 absolute drift on Lorenz63-4k from
    # exactly this, vs 1.7 for the unstacked marginal filter.  The ODE
    # top-left block of the stacked forecast equals the unstacked ODE
    # forecast bitwise (zero obs weights contribute exact zeros), so
    # slicing is exact.
    logp_zy_stack = logpdf(
        stack["x_stack"], mean=stack["fore_mean_zy"],
        cov=stack["fore_var_zy"])                         # (N, nb)
    logp_zy_ode = logpdf(
        stack["x_stack"][..., :n_bmeas],
        mean=stack["fore_mean_zy"][..., :n_bmeas],
        cov=stack["fore_var_zy"][..., :n_bmeas, :n_bmeas])
    logp_zy = jnp.where(mask[1:, None] > 0.5, logp_zy_stack, logp_zy_ode)
    logdens_zy = mask[0] * logp0 + jnp.sum(logp_zy)
    logp_z = logpdf(
        jnp.zeros_like(stack["fore_mean_z"]), mean=stack["fore_mean_z"],
        cov=stack["fore_var_z"])
    logdens_z = jnp.sum(logp_z)
    return logdens_zy, logdens_z


# --- ODE solver --------------------------------------------------------------


def _solve_filter(key, ode_fun, ode_weight, ode_init,
                  t_min, t_max, n_steps,
                  interrogate,
                  prior_weight, prior_var,
                  obs_data, obs_times, obs_weight, obs_var,
                  kalman_funs, **params):
    r"""
    Forward pass of DALTON with Gaussian observations folded into the update.
    Parity: ``dalton.py:242-371``.

    Returns the same ``state_filt`` / ``state_pred`` pytree as
    :func:`rodeo_tpu.solve._solve_filter`.
    """
    from rodeo_tpu.kalmantv import standard as _standard
    if kalman_funs is _standard:
        return _solve_filter_dense(
            key=key, ode_fun=ode_fun, ode_weight=ode_weight,
            ode_init=ode_init, t_min=t_min, t_max=t_max, n_steps=n_steps,
            interrogate=interrogate, prior_weight=prior_weight,
            prior_var=prior_var, obs_data=obs_data, obs_times=obs_times,
            obs_weight=obs_weight, obs_var=obs_var,
            kalman_funs=kalman_funs, **params)

    n_block, n_bmeas, n_bstate = ode_weight.shape
    n_bobs = obs_weight.shape[2]

    sim_times = jnp.linspace(t_min, t_max, n_steps + 1)
    obs_ind = jnp.searchsorted(sim_times, obs_times)

    dtype = ode_init.dtype
    x_meas = jnp.zeros((n_block, n_bmeas), dtype=dtype)
    obs_mean = jnp.zeros((n_block, n_bobs), dtype=dtype)
    mean_state = jnp.zeros((n_block, n_bstate), dtype=dtype)
    mean_state_init = ode_init
    var_state_init = jnp.zeros((n_block, n_bstate, n_bstate), dtype=dtype)

    def scan_fun(carry, step):
        mean_state_filt, var_state_filt = carry["state_filt"]
        i = carry["i"]
        t = step["t"]
        key_n = step["key"]
        ode_time = t_min + (t_max - t_min) * (t + 1) / n_steps

        mean_state_pred, var_state_pred = kalman_funs.predict(
            mean_state_past=mean_state_filt,
            var_state_past=var_state_filt,
            mean_state=mean_state,
            wgt_state=prior_weight,
            var_state=prior_var,
        )
        wgt_meas, mean_meas, var_meas = interrogate(
            key=key_n,
            ode_fun=ode_fun,
            ode_weight=ode_weight,
            t=ode_time,
            mean_state_pred=mean_state_pred,
            var_state_pred=var_state_pred,
            **params,
        )
        W_meas = ode_weight + wgt_meas

        def zy_update():
            wgt_meas_obs = jnp.concatenate([W_meas, obs_weight[i]], axis=1)
            mean_meas_obs = jnp.concatenate([mean_meas, obs_mean], axis=1)
            var_meas_obs = _block_diag2(var_meas, obs_var[i])
            x_meas_obs = jnp.concatenate([x_meas, obs_data[i]], axis=1)
            mean_state_next, var_state_next = kalman_funs.update(
                mean_state_pred=mean_state_pred,
                var_state_pred=var_state_pred,
                x_meas=x_meas_obs,
                mean_meas=mean_meas_obs,
                wgt_meas=wgt_meas_obs,
                var_meas=var_meas_obs,
            )
            return mean_state_next, var_state_next, i + 1

        def z_update():
            mean_state_next, var_state_next = kalman_funs.update(
                mean_state_pred=mean_state_pred,
                var_state_pred=var_state_pred,
                x_meas=x_meas,
                mean_meas=mean_meas,
                wgt_meas=W_meas,
                var_meas=var_meas,
            )
            return mean_state_next, var_state_next, i

        mean_state_next, var_state_next, i = jax.lax.cond(
            t + 1 == obs_ind[i], zy_update, z_update)
        carry = {"state_filt": (mean_state_next, var_state_next), "i": i}
        stack = {
            "state_filt": (mean_state_next, var_state_next),
            "state_pred": (mean_state_pred, var_state_pred),
        }
        return carry, stack

    i = jax.lax.cond(obs_ind[0] == 0, lambda: 1, lambda: 0)
    scan_init = {"state_filt": (mean_state_init, var_state_init), "i": i}
    if key is not None:
        keys = jax.random.split(key, num=n_steps)
    else:
        keys = jnp.zeros(n_steps)
    steps = {"t": jnp.arange(n_steps), "key": keys}
    _, scan_out = _uscan(scan_fun, scan_init, steps)
    scan_out["state_filt"] = (
        jnp.concatenate([mean_state_init[None], scan_out["state_filt"][0]]),
        jnp.concatenate([var_state_init[None], scan_out["state_filt"][1]]),
    )
    scan_out["state_pred"] = (
        jnp.concatenate([mean_state_init[None], scan_out["state_pred"][0]]),
        jnp.concatenate([var_state_init[None], scan_out["state_pred"][1]]),
    )
    return scan_out


def _solve_filter_dense(key, ode_fun, ode_weight, ode_init,
                        t_min, t_max, n_steps,
                        interrogate,
                        prior_weight, prior_var,
                        obs_data, obs_times, obs_weight, obs_var,
                        kalman_funs, **params):
    r"""
    Masked-dense data-conditioned forward filter (standard form) with the
    grid-scattered observation model, instead of the reference's per-step
    branch + index carry
    (``/root/reference/src/rodeo/inference/dalton.py:242-371``).
    Measurements are processed **sequentially** (ODE update, then the
    masked observation update — exactly a bitwise identity at no-obs
    steps): algebraically identical to the stacked ``[W_meas; D]`` update
    for block-diagonal joint noise, but float32-robust where the stacked
    2x2 system (ODE variance ~1e10 under a diffuse prior paired with a
    unit dead row) is catastrophically ill-conditioned — see
    :func:`_dalton_dense_parts`.
    """
    n_block, n_bmeas, n_bstate = ode_weight.shape
    n_bobs = obs_weight.shape[2]
    dtype = ode_init.dtype

    d_grid, y_grid, om_grid, _ = _obs_grid(
        t_min, t_max, n_steps, obs_data, obs_times, obs_weight, obs_var,
        dtype)
    x_meas = jnp.zeros((n_block, n_bmeas), dtype=dtype)
    obs_mean = jnp.zeros((n_block, n_bobs), dtype=dtype)
    mean_state = jnp.zeros((n_block, n_bstate), dtype=dtype)
    var_state_init = jnp.zeros((n_block, n_bstate, n_bstate), dtype=dtype)

    def scan_fun(carry, xs):
        mean_state_filt, var_state_filt = carry
        ode_time = t_min + (t_max - t_min) * (xs["t"] + 1) / n_steps
        mean_state_pred, var_state_pred = kalman_funs.predict(
            mean_state_past=mean_state_filt,
            var_state_past=var_state_filt,
            mean_state=mean_state,
            wgt_state=prior_weight,
            var_state=prior_var,
        )
        wgt_meas, mean_meas, var_meas = interrogate(
            key=xs["key"],
            ode_fun=ode_fun,
            ode_weight=ode_weight,
            t=ode_time,
            mean_state_pred=mean_state_pred,
            var_state_pred=var_state_pred,
            **params,
        )
        mean_state_mid, var_state_mid = kalman_funs.update(
            mean_state_pred=mean_state_pred,
            var_state_pred=var_state_pred,
            x_meas=x_meas,
            mean_meas=mean_meas,
            wgt_meas=ode_weight + wgt_meas,
            var_meas=var_meas,
        )
        mean_state_next, var_state_next = kalman_funs.update(
            mean_state_pred=mean_state_mid,
            var_state_pred=var_state_mid,
            x_meas=xs["y"],
            mean_meas=obs_mean,
            wgt_meas=xs["D"],
            var_meas=xs["Om"],
        )
        carry = (mean_state_next, var_state_next)
        stack = {
            "state_filt": (mean_state_next, var_state_next),
            "state_pred": (mean_state_pred, var_state_pred),
        }
        return carry, stack

    if key is not None:
        keys = jax.random.split(key, num=n_steps)
    else:
        keys = jnp.zeros(n_steps)
    xs = {
        "t": jnp.arange(n_steps), "key": keys,
        "D": d_grid[1:], "y": y_grid[1:], "Om": om_grid[1:],
    }
    _, scan_out = _uscan(scan_fun, (ode_init, var_state_init), xs)
    scan_out["state_filt"] = (
        jnp.concatenate([ode_init[None], scan_out["state_filt"][0]]),
        jnp.concatenate([var_state_init[None], scan_out["state_filt"][1]]),
    )
    scan_out["state_pred"] = (
        jnp.concatenate([ode_init[None], scan_out["state_pred"][0]]),
        jnp.concatenate([var_state_init[None], scan_out["state_pred"][1]]),
    )
    return scan_out


def _smooth_mv_pass(ode_init, filt_out, prior_weight, prior_var, kalman_funs):
    """Shared reverse mean/variance smoothing pass over a forward-filter
    output pytree.  Used by :func:`solve_mv` and :func:`solve_mv_nn`
    (parity: ``dalton.py:417-460`` and ``dalton.py:996-1039``)."""
    mean_state_pred, var_state_pred = filt_out["state_pred"]
    mean_state_filt, var_state_filt = filt_out["state_filt"]
    n_steps = mean_state_filt.shape[0] - 1
    n_block, n_bstate = ode_init.shape

    def scan_fun(state_next, smooth_kwargs):
        mean_state_curr, var_state_curr = kalman_funs.smooth_mv(
            mean_state_next=state_next["mean"],
            var_state_next=state_next["var"],
            wgt_state=prior_weight,
            mean_state_filt=smooth_kwargs["mean_state_filt"],
            var_state_filt=smooth_kwargs["var_state_filt"],
            mean_state_pred=smooth_kwargs["mean_state_pred"],
            var_state_pred=smooth_kwargs["var_state_pred"],
            var_state=prior_var,
        )
        state_curr = {"mean": mean_state_curr, "var": var_state_curr}
        return state_curr, state_curr

    scan_init = {
        "mean": mean_state_filt[n_steps],
        "var": var_state_filt[n_steps],
    }
    scan_kwargs = {
        "mean_state_filt": mean_state_filt[1:n_steps],
        "var_state_filt": var_state_filt[1:n_steps],
        "mean_state_pred": mean_state_pred[2:n_steps + 1],
        "var_state_pred": var_state_pred[2:n_steps + 1],
    }
    _, scan_out = _uscan(scan_fun, scan_init, scan_kwargs, reverse=True)
    mean_state_smooth = jnp.concatenate(
        [ode_init[None], scan_out["mean"], scan_init["mean"][None]])
    var_state_smooth = jnp.concatenate(
        [jnp.zeros((1, n_block, n_bstate, n_bstate), dtype=ode_init.dtype),
         scan_out["var"], scan_init["var"][None]])
    return mean_state_smooth, var_state_smooth


@full_matmul_precision
def solve_mv(key, ode_fun, ode_weight, ode_init,
             t_min, t_max, n_steps,
             interrogate,
             prior_pars,
             obs_data, obs_times, obs_weight, obs_var,
             kalman_type="standard", **params):
    r"""
    DALTON data-conditioned posterior mean and variance of
    :math:`p(X_{0:N} \mid Y_{0:M}, Z_{1:N})` for Gaussian observations.
    Same arguments as :func:`dalton`.  Parity: ``dalton.py:374-460``
    (with the ``var_State`` typo of line 430 fixed, so the square-root
    backend works).

    Returns:
        (tuple): ``mean_state_smooth``, ``var_state_smooth``.
    """
    prior_weight, prior_var = prior_pars
    kalman_funs = get_backend(kalman_type)
    filt_out = _solve_filter(
        key=key,
        ode_fun=ode_fun, ode_weight=ode_weight, ode_init=ode_init,
        t_min=t_min, t_max=t_max, n_steps=n_steps,
        interrogate=interrogate,
        prior_weight=prior_weight, prior_var=prior_var,
        obs_data=obs_data, obs_times=obs_times,
        obs_weight=obs_weight, obs_var=obs_var,
        kalman_funs=kalman_funs, **params,
    )
    return _smooth_mv_pass(
        ode_init, filt_out, prior_weight, prior_var, kalman_funs)


@full_matmul_precision
def solve_sim(key, ode_fun, ode_weight, ode_init,
              t_min, t_max, n_steps,
              interrogate,
              prior_pars,
              obs_data, obs_times, obs_weight, obs_var,
              kalman_type="standard", **params):
    r"""
    DALTON posterior path sampler from
    :math:`p(X_{0:N} \mid Y_{0:M}, Z_{1:N})` for Gaussian observations.
    Same arguments as :func:`dalton`.  Parity: ``dalton.py:463-545``.

    Returns:
        (ndarray(n_steps+1, n_block, n_bstate)): Sample solution path.
    """
    prior_weight, prior_var = prior_pars
    kalman_funs = get_backend(kalman_type)
    key, *subkeys = jax.random.split(key, num=n_steps + 1)
    filt_out = _solve_filter(
        key=key,
        ode_fun=ode_fun, ode_weight=ode_weight, ode_init=ode_init,
        t_min=t_min, t_max=t_max, n_steps=n_steps,
        interrogate=interrogate,
        prior_weight=prior_weight, prior_var=prior_var,
        obs_data=obs_data, obs_times=obs_times,
        obs_weight=obs_weight, obs_var=obs_var,
        kalman_funs=kalman_funs, **params,
    )
    mean_state_pred, var_state_pred = filt_out["state_pred"]
    mean_state_filt, var_state_filt = filt_out["state_filt"]

    def scan_fun(x_state_next, smooth_kwargs):
        mean_state_sim, var_state_sim = kalman_funs.smooth_sim(
            x_state_next=x_state_next,
            wgt_state=prior_weight,
            mean_state_filt=smooth_kwargs["mean_state_filt"],
            var_state_filt=smooth_kwargs["var_state_filt"],
            mean_state_pred=smooth_kwargs["mean_state_pred"],
            var_state_pred=smooth_kwargs["var_state_pred"],
            var_state=prior_var,
        )
        x_state_curr = jax.random.multivariate_normal(
            smooth_kwargs["key"], mean_state_sim, var_state_sim, method="svd")
        return x_state_curr, x_state_curr

    scan_init = jax.random.multivariate_normal(
        subkeys[n_steps - 1],
        mean_state_filt[n_steps],
        var_state_filt[n_steps],
        method="svd")
    scan_kwargs = {
        "mean_state_filt": mean_state_filt[1:n_steps],
        "var_state_filt": var_state_filt[1:n_steps],
        "mean_state_pred": mean_state_pred[2:n_steps + 1],
        "var_state_pred": var_state_pred[2:n_steps + 1],
        "key": jnp.array(subkeys[:n_steps - 1]),
    }
    _, scan_out = _uscan(scan_fun, scan_init, scan_kwargs, reverse=True)
    return jnp.concatenate([ode_init[None], scan_out, scan_init[None]])


# --- non-Gaussian loglikelihood ------------------------------------------------


def _solve_filter_nn(key, ode_fun, ode_weight, ode_init,
                     t_min, t_max, n_steps,
                     interrogate,
                     prior_weight, prior_var,
                     obs_data, obs_times, obs_loglik_i,
                     kalman_funs, **params):
    r"""
    Forward pass of DALTON with non-Gaussian observations, each
    Laplace-linearized into a Gaussian pseudo-observation
    :math:`\hat y = D \mu_{n|n-1} + \hat\Omega \nabla \ell` with
    :math:`\hat\Omega = -(\nabla^2 \ell)^{+}`.  Parity: ``dalton.py:550-698``.
    """
    n_block, n_bmeas, n_bstate = ode_weight.shape

    sim_times = jnp.linspace(t_min, t_max, n_steps + 1)
    obs_ind = jnp.searchsorted(sim_times, obs_times)

    dtype = ode_init.dtype
    x_meas = jnp.zeros((n_block, n_bmeas), dtype=dtype)
    obs_mean = jnp.zeros((n_block, n_bstate), dtype=dtype)
    mean_state = jnp.zeros((n_block, n_bstate), dtype=dtype)
    mean_state_init = ode_init
    var_state_init = jnp.zeros((n_block, n_bstate, n_bstate), dtype=dtype)

    def scan_fun(carry, step):
        mean_state_filt, var_state_filt = carry["state_filt"]
        i = carry["i"]
        t = step["t"]
        key_n = step["key"]
        ode_time = t_min + (t_max - t_min) * (t + 1) / n_steps

        mean_state_pred, var_state_pred = kalman_funs.predict(
            mean_state_past=mean_state_filt,
            var_state_past=var_state_filt,
            mean_state=mean_state,
            wgt_state=prior_weight,
            var_state=prior_var,
        )
        wgt_meas, mean_meas, var_meas = interrogate(
            key=key_n,
            ode_fun=ode_fun,
            ode_weight=ode_weight,
            t=ode_time,
            mean_state_pred=mean_state_pred,
            var_state_pred=var_state_pred,
            **params,
        )
        W_meas = ode_weight + wgt_meas
        # ODE update, common to both branches; the observation branch
        # conditions on its Laplace pseudo-observation *sequentially* on
        # top of this (exactly the stacked joint update for the
        # block-diagonal joint noise, but without the ~1e10-condition
        # stacked innovation solve that poisons float32 — see
        # :func:`_dalton_dense_parts`), and the branches no longer
        # duplicate the update work that `vmap`-over-`cond` executes on
        # every step.
        mean_state_mid, var_state_mid = kalman_funs.update(
            mean_state_pred=mean_state_pred,
            var_state_pred=var_state_pred,
            x_meas=x_meas,
            mean_meas=mean_meas,
            wgt_meas=W_meas,
            var_meas=var_meas,
        )

        def zy_update():
            # Laplace linearization of the observation log-likelihood
            obs_grad = jax.jacrev(obs_loglik_i, argnums=1)(
                obs_data[i], mean_state_pred, i, **params)
            obs_hes = jax.jacfwd(jax.jacrev(obs_loglik_i, argnums=1), argnums=1)(
                obs_data[i], mean_state_pred, i, **params)
            # block diagonal of the Hessian, per-block pseudo-inverse
            hes_diag = jnp.moveaxis(
                jnp.diagonal(obs_hes, axis1=0, axis2=2), -1, 0)
            from rodeo_tpu.ops.linalg import fast_linalg_enabled, inv_small
            if fast_linalg_enabled() and hes_diag.shape[-1] <= 5:
                # closed-form masked inverse instead of pinv: pinv lowers
                # to an SVD per step, and under vmap the cond below runs
                # BOTH branches — 4k SVDs per likelihood eval.  State
                # components the log-likelihood never touches give exact
                # zero Hessian rows; regularize them to -1 on the
                # diagonal, invert in closed form, and zero them back —
                # equal to pinv whenever the live submatrix is invertible
                # (always, for a nondegenerate Laplace linearization).
                live = jnp.any(hes_diag != 0, axis=-1)  # (n_block, q)
                eye_q = jnp.eye(hes_diag.shape[-1], dtype=hes_diag.dtype)
                dead_diag = eye_q * (~live).astype(
                    hes_diag.dtype)[..., None, :]
                neg_hes = -(hes_diag) + dead_diag
                # a live-but-numerically-singular block would blow up the
                # adjugate inverse (pinv returned a bounded pseudo-inverse
                # here); detect it via the determinant of the DIAGONALLY
                # EQUILIBRATED block (scale-invariant per row) and
                # Tikhonov-regularize before inverting — a small positive
                # per-row-scaled ridge on -Hess (PSD for concave
                # log-likelihoods) that leaves well-conditioned blocks
                # bit-identical.  A global max-entry normalization is
                # wrong here: the dead-row unit diagonal sits next to
                # live entries scaled by t_vec[0]^2 (~1e-10 on fine
                # grids), so the globally-normalized determinant of a
                # perfectly conditioned diagonal block underflows the f32
                # tolerance and the ridge misfired on EVERY observation —
                # the pseudo-observation then pulled only O(1e-2) of the
                # way to the data and the float32 filter silently lost
                # the trajectory (the 2-4x daltonng drift in the r03
                # bench audit, absent in f64 only because the f64
                # tolerance is 1e9 smaller).
                from rodeo_tpu.ops.linalg import _det_small_normed
                dn = jnp.abs(jnp.diagonal(neg_hes, axis1=-2, axis2=-1))
                dn = jnp.maximum(dn, jnp.asarray(
                    jnp.finfo(hes_diag.dtype).tiny, hes_diag.dtype))
                s = 1.0 / jnp.sqrt(dn)
                corr = neg_hes * (s[..., :, None] * s[..., None, :])
                detn = _det_small_normed(corr)[..., None, None]
                det_tol = jnp.asarray(
                    jnp.finfo(hes_diag.dtype).eps, hes_diag.dtype) * 100
                ridge = jnp.where(jnp.abs(detn) < det_tol,
                                  jnp.sqrt(det_tol), 0.0)
                inv_reg = inv_small(
                    neg_hes + ridge * dn[..., :, None] * eye_q)
                mask = (live[..., :, None] & live[..., None, :]).astype(
                    hes_diag.dtype)
                obs_var_hat = inv_reg * mask
            else:
                obs_var_hat = -jnp.linalg.pinv(hes_diag)
            obs_wgt_hat = jnp.where(obs_var_hat != 0, 1.0, 0.0).astype(dtype)
            # vacuous rows (state components the log-likelihood does not
            # touch: zero weight AND zero variance) make the stacked
            # innovation matrix exactly singular; give them unit variance
            # so they become exact identity updates (zero gain).  The
            # reference (upstream ``dalton.py:613-622``) leaves them
            # singular and relies on the zero-residual cancellation, which
            # NaNs under f32/fast-linalg.
            dead = jnp.all(obs_wgt_hat == 0, axis=-1)
            obs_var_hat = obs_var_hat + (
                jnp.eye(obs_var_hat.shape[-1], dtype=dtype)
                * dead[..., None].astype(dtype))
            obs_hat = mvdot(obs_wgt_hat, mean_state_pred) + \
                mvdot(obs_var_hat, obs_grad)
            # sequential pseudo-observation update on top of the ODE
            # update (dead rows: zero weight + unit variance = exact
            # identity)
            mean_state_next, var_state_next = kalman_funs.update(
                mean_state_pred=mean_state_mid,
                var_state_pred=var_state_mid,
                x_meas=obs_hat,
                mean_meas=obs_mean,
                wgt_meas=obs_wgt_hat,
                var_meas=obs_var_hat,
            )
            return mean_state_next, var_state_next, i + 1

        def z_update():
            return mean_state_mid, var_state_mid, i

        mean_state_next, var_state_next, i = jax.lax.cond(
            t + 1 == obs_ind[i], zy_update, z_update)
        carry = {"state_filt": (mean_state_next, var_state_next), "i": i}
        stack = {
            "state_filt": (mean_state_next, var_state_next),
            "state_pred": (mean_state_pred, var_state_pred),
        }
        return carry, stack

    i = jax.lax.cond(obs_ind[0] == 0, lambda: 1, lambda: 0)
    scan_init = {"state_filt": (mean_state_init, var_state_init), "i": i}
    if key is not None:
        keys = jax.random.split(key, num=n_steps)
    else:
        keys = jnp.zeros(n_steps)
    steps = {"t": jnp.arange(n_steps), "key": keys}
    _, scan_out = _uscan(scan_fun, scan_init, steps)
    scan_out["state_filt"] = (
        jnp.concatenate([mean_state_init[None], scan_out["state_filt"][0]]),
        jnp.concatenate([var_state_init[None], scan_out["state_filt"][1]]),
    )
    scan_out["state_pred"] = (
        jnp.concatenate([mean_state_init[None], scan_out["state_pred"][0]]),
        jnp.concatenate([var_state_init[None], scan_out["state_pred"][1]]),
    )
    return scan_out


def _is_standard(kalman_funs):
    return kalman_funs.__name__.rsplit(".", 1)[-1] == "standard"


def _logx_yhat(mean_state_filt, var_state_filt,
               mean_state_pred, var_state_pred,
               prior_weight, prior_var, kalman_funs):
    r"""
    Smoothing pass returning the smoothed mean path and the log-density
    :math:`\log p(X_{0:N} = \mu_{0:N|N} \mid \hat Y_{0:M}, Z_{1:N})`.
    Parity: ``dalton.py:701-784``.

    Fast path (standard form): the backward-kernel parameters
    ``(A, b, C)`` hoist out of the loop as one batched ``smooth_cond``;
    the scan keeps only the mean recursion
    :math:`\mu_n = A_n \mu_{n+1} + b_n` (the variance recursion is not
    needed for the value), and — since the reference evaluates the
    backward kernel *at* the smoothed mean, where the quadratic form
    vanishes identically — the per-step log-density reduces to one
    batched ``logpdf(mu_n; mu_n, C_n)`` over the stacked means.
    """
    n_tot = mean_state_filt.shape[0]
    n_steps = n_tot - 1

    if _is_standard(kalman_funs):
        A, b, C = kalman_funs.smooth_cond(
            mean_state_filt=mean_state_filt[1:n_steps],
            var_state_filt=var_state_filt[1:n_steps],
            mean_state_pred=mean_state_pred[2:n_steps + 1],
            var_state_pred=var_state_pred[2:n_steps + 1],
            wgt_state=prior_weight,
            var_state=prior_var,
        )

        def scan_fun(mean_next, xs):
            mean_curr = mvdot(xs["A"], mean_next) + xs["b"]
            return mean_curr, mean_curr

        _, means = _uscan(scan_fun, mean_state_filt[n_steps],
                          {"A": A, "b": b}, reverse=True)
        mean_out = jnp.concatenate(
            [mean_state_filt[0][None], means,
             mean_state_filt[n_steps][None]])
        logx_yhat = jnp.sum(multivariate_normal_logpdf(
            mean_state_filt[n_steps], mean=mean_state_filt[n_steps],
            cov=var_state_filt[n_steps]))
        logx_yhat += jnp.sum(multivariate_normal_logpdf(
            means, mean=means, cov=C))
        return mean_out, logx_yhat

    def scan_fun(state_next, smooth_kwargs):
        logx_yhat = state_next["logx_yhat"]
        mean_state_curr, var_state_curr = kalman_funs.smooth_mv(
            mean_state_next=state_next["mean"],
            var_state_next=state_next["var"],
            mean_state_filt=smooth_kwargs["mean_state_filt"],
            var_state_filt=smooth_kwargs["var_state_filt"],
            mean_state_pred=smooth_kwargs["mean_state_pred"],
            var_state_pred=smooth_kwargs["var_state_pred"],
            wgt_state=prior_weight,
            var_state=prior_var,
        )
        mean_state_sim, var_state_sim = kalman_funs.smooth_sim(
            x_state_next=state_next["mean"],
            mean_state_filt=smooth_kwargs["mean_state_filt"],
            var_state_filt=smooth_kwargs["var_state_filt"],
            mean_state_pred=smooth_kwargs["mean_state_pred"],
            var_state_pred=smooth_kwargs["var_state_pred"],
            wgt_state=prior_weight,
            var_state=prior_var,
        )
        logx_yhat += jnp.sum(multivariate_normal_logpdf(
            mean_state_curr, mean=mean_state_sim, cov=var_state_sim))
        carry = {
            "mean": mean_state_curr,
            "var": var_state_curr,
            "logx_yhat": logx_yhat,
        }
        return carry, carry

    logx_yhatN = jnp.sum(multivariate_normal_logpdf(
        mean_state_filt[n_steps],
        mean=mean_state_filt[n_steps],
        cov=var_state_filt[n_steps]))
    scan_init = {
        "mean": mean_state_filt[n_steps],
        "var": var_state_filt[n_steps],
        "logx_yhat": logx_yhatN,
    }
    scan_kwargs = {
        "mean_state_filt": mean_state_filt[1:n_steps],
        "var_state_filt": var_state_filt[1:n_steps],
        "mean_state_pred": mean_state_pred[2:n_steps + 1],
        "var_state_pred": var_state_pred[2:n_steps + 1],
    }
    last_scan, scan_out = _uscan(
        scan_fun, scan_init, scan_kwargs, reverse=True)
    mean_out = jnp.concatenate(
        [mean_state_filt[0][None], scan_out["mean"], scan_init["mean"][None]])
    return mean_out, last_scan["logx_yhat"]


def _logx_z(uncond_mean,
            mean_state_filt, var_state_filt,
            mean_state_pred, var_state_pred,
            prior_weight, prior_var, kalman_funs):
    r"""
    Log-density :math:`\log p(X_{0:N} = \text{uncond\_mean} \mid Z_{1:N})`
    evaluated along the backward Markov chain.  Parity: ``dalton.py:787-849``.
    """
    n_tot = mean_state_filt.shape[0]
    n_steps = n_tot - 1

    logx_zN = jnp.sum(multivariate_normal_logpdf(
        uncond_mean[n_steps],
        mean=mean_state_filt[n_steps],
        cov=var_state_filt[n_steps]))

    if _is_standard(kalman_funs):
        # no sequential dependence at all: every term is a function of
        # the stored moments and the precomputed unconditional path, so
        # the whole pass is one batched smooth_cond + one batched logpdf
        A, b, C = kalman_funs.smooth_cond(
            mean_state_filt=mean_state_filt[1:n_steps],
            var_state_filt=var_state_filt[1:n_steps],
            mean_state_pred=mean_state_pred[2:n_steps + 1],
            var_state_pred=var_state_pred[2:n_steps + 1],
            wgt_state=prior_weight,
            var_state=prior_var,
        )
        mean_sim = mvdot(A, uncond_mean[2:n_steps + 1]) + b
        return logx_zN + jnp.sum(multivariate_normal_logpdf(
            uncond_mean[1:n_steps], mean=mean_sim, cov=C))

    def scan_fun(logx_z, smooth_kwargs):
        mean_state_sim, var_state_sim = kalman_funs.smooth_sim(
            x_state_next=smooth_kwargs["uncond_next"],
            mean_state_filt=smooth_kwargs["mean_state_filt"],
            var_state_filt=smooth_kwargs["var_state_filt"],
            mean_state_pred=smooth_kwargs["mean_state_pred"],
            var_state_pred=smooth_kwargs["var_state_pred"],
            wgt_state=prior_weight,
            var_state=prior_var,
        )
        logx_z += jnp.sum(multivariate_normal_logpdf(
            smooth_kwargs["uncond_curr"],
            mean=mean_state_sim, cov=var_state_sim))
        return logx_z, logx_z

    scan_kwargs = {
        "mean_state_filt": mean_state_filt[1:n_steps],
        "var_state_filt": var_state_filt[1:n_steps],
        "mean_state_pred": mean_state_pred[2:n_steps + 1],
        "var_state_pred": var_state_pred[2:n_steps + 1],
        "uncond_next": uncond_mean[2:n_steps + 1],
        "uncond_curr": uncond_mean[1:n_steps],
    }
    scan_out, _ = _uscan(scan_fun, logx_zN, scan_kwargs, reverse=True)
    return scan_out


@full_matmul_precision
def daltonng(key, ode_fun, ode_weight, ode_init,
             t_min, t_max, n_steps,
             interrogate,
             prior_pars,
             obs_data, obs_times, obs_loglik_i,
             kalman_type="standard", **params):
    r"""
    DALTON marginal log-likelihood for non-Gaussian observations,
    :math:`\log p(\hat Y_{0:M} \mid Z_{1:N})`, assembled as
    ``logy_x + logx_z - logx_yhat``.  Parity: ``dalton.py:851-949``.

    Args:
        obs_loglik_i (Callable): Per-observation log-likelihood
            ``obs_loglik_i(obs_data_i, state, i, **params)``.
        (other arguments as in :func:`dalton`)

    Returns:
        (float): The log-likelihood value.
    """
    n_obs = obs_data.shape[0]
    kalman_funs = get_backend(kalman_type)
    prior_weight, prior_var = prior_pars

    filt_out = _solve_filter_nn(
        key=key,
        ode_fun=ode_fun, ode_weight=ode_weight, ode_init=ode_init,
        t_min=t_min, t_max=t_max, n_steps=n_steps,
        interrogate=interrogate,
        prior_weight=prior_weight, prior_var=prior_var,
        obs_data=obs_data, obs_times=obs_times,
        obs_loglik_i=obs_loglik_i,
        kalman_funs=kalman_funs, **params,
    )
    mean_state_smooth, logx_yhat = _logx_yhat(
        mean_state_filt=filt_out["state_filt"][0],
        var_state_filt=filt_out["state_filt"][1],
        mean_state_pred=filt_out["state_pred"][0],
        var_state_pred=filt_out["state_pred"][1],
        prior_weight=prior_weight,
        prior_var=prior_var,
        kalman_funs=kalman_funs,
    )
    # log p(Y_{0:M} | X at the smoothed means)
    sim_times = jnp.linspace(t_min, t_max, n_steps + 1)
    obs_ind = jnp.searchsorted(sim_times, obs_times)

    def _obs_ll(i):
        return obs_loglik_i(obs_data[i], mean_state_smooth[obs_ind[i]],
                            i, **params)

    logy_x = jnp.sum(jax.vmap(_obs_ll)(jnp.arange(n_obs)))

    # log p(X_{0:N} | Z_{1:N}) along the same path
    filt_out = _solve_filter_ode(
        key=key,
        ode_fun=ode_fun, ode_weight=ode_weight, ode_init=ode_init,
        t_min=t_min, t_max=t_max, n_steps=n_steps,
        interrogate=interrogate,
        prior_weight=prior_weight, prior_var=prior_var,
        kalman_funs=kalman_funs, **params,
    )
    logx_z = _logx_z(
        uncond_mean=mean_state_smooth,
        mean_state_filt=filt_out["state_filt"][0],
        var_state_filt=filt_out["state_filt"][1],
        mean_state_pred=filt_out["state_pred"][0],
        var_state_pred=filt_out["state_pred"][1],
        prior_weight=prior_weight,
        prior_var=prior_var,
        kalman_funs=kalman_funs,
    )
    return logy_x + logx_z - logx_yhat


# --- non-Gaussian ODE solver ---------------------------------------------------


@full_matmul_precision
def solve_mv_nn(key, ode_fun, ode_weight, ode_init,
                t_min, t_max, n_steps,
                interrogate,
                prior_pars,
                obs_data, obs_times, obs_loglik_i,
                kalman_type="standard", **params):
    r"""
    DALTON posterior mean/variance of
    :math:`p(X_{0:N} \mid \hat Y_{0:M}, Z_{1:N})` for non-Gaussian
    observations.  Same arguments as :func:`daltonng`.
    Parity: ``dalton.py:955-1039``.

    Returns:
        (tuple): ``mean_state_smooth``, ``var_state_smooth``.
    """
    prior_weight, prior_var = prior_pars
    kalman_funs = get_backend(kalman_type)
    filt_out = _solve_filter_nn(
        key=key,
        ode_fun=ode_fun, ode_weight=ode_weight, ode_init=ode_init,
        t_min=t_min, t_max=t_max, n_steps=n_steps,
        interrogate=interrogate,
        prior_weight=prior_weight, prior_var=prior_var,
        obs_data=obs_data, obs_times=obs_times,
        obs_loglik_i=obs_loglik_i,
        kalman_funs=kalman_funs, **params,
    )
    return _smooth_mv_pass(
        ode_init, filt_out, prior_weight, prior_var, kalman_funs)
