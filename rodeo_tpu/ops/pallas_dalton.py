r"""
Fused DALTON likelihood (lane-batched).

DALTON (``rodeo_tpu/inference/dalton.py``, reference ``dalton.py:39-235``)
is the difference of two forward-filter log-densities:
``log p(Z, Y) - log p(Z)``.  Both filters are one pure step function run
over time by :func:`rodeo_tpu.ops.scan.scan_steps`:

* the per-step ODE forecast log-density falls out of quantities the
  filter already computes (the innovation ``z`` and its variance ``S``);
* the observation rows are folded in by *sequential measurement
  processing* — a masked scalar observation update after the ODE update,
  which is exactly equivalent to the reference's stacked
  ``[W_meas; D]`` joint update because the ODE and observation noises are
  independent (block-diagonal joint ``V``), and replaces the per-step
  ``lax.cond`` with dense masked math;
* only the accumulated log-density leaves the loop — no per-step state
  is stored at all.

Supported configuration (XLA path otherwise): ``n_bmeas == n_bobs == 1``,
standard form, EK1/EK0 interrogations, observations on grid points,
block-constant transition (IBM prior).
"""
import jax
import jax.numpy as jnp

from rodeo_tpu.ops.flat_rows import flat_call
from rodeo_tpu.ops.precond import taylor_scale, scale_prior
from rodeo_tpu.ops.pallas_kalman import (
    _tri_idx, _pack_tri, _sym_quadform, _matvec, _acc,
    _static_scaled_qconst, p_cols_at, resolve_kalman_type,
    normalize_prior_pars, normalize_meas_var)
from rodeo_tpu.ops.scan import scan_steps

__all__ = ["dalton_fused_batch", "dalton_fused_batch_grad"]

_LOG2PI = 1.8378770664093453


def _dalton_step_pure(ode_flat, jac_flat, with_obs, q, where, pairs,
                      q_const, R_cols, W_cols, tv_cols, t_n,
                      D, y, om, mask):
    """Pure per-step DALTON filter update (ODE forecast log-density plus
    the optional masked observation update) in column form.  The
    observation inputs
    (D, y, om, mask) are theta-independent and closed over, so tangents
    flow only through (m, p, ld, theta)."""

    def step(m_cols, p_cols, ld, th):
        m_cols, p_cols = list(m_cols), list(p_cols)
        mp_cols = _matvec(q, q_const, m_cols)
        pp_cols = _sym_quadform(q, q_const, p_cols, where)
        pp_cols = [pp_cols[k] + R_cols[k] for k in range(len(pp_cols))]
        x_cols = [mp_cols[j] * tv_cols[j] for j in range(q)]
        f0 = flat_call(ode_flat, x_cols, th, t_n)
        jd_cols = flat_call(jac_flat, x_cols, th, t_n) \
            if jac_flat is not None else [None] * q
        H_cols = []
        for j in range(q):
            if jd_cols[j] is None:
                H_cols.append(W_cols[j])
            else:
                H_cols.append(W_cols[j] - jd_cols[j] * tv_cols[j])
        hm = None
        for j in range(q):
            hm = _acc(hm, H_cols[j] * mp_cols[j])
        mm = -f0
        for j in range(q):
            if jd_cols[j] is not None:
                mm = mm + jd_cols[j] * x_cols[j]
        z = -(hm + mm)
        PH_cols = []
        for i in range(q):
            acc = None
            for j in range(q):
                acc = _acc(acc, p_cols_at(pp_cols, where, i, j) * H_cols[j])
            PH_cols.append(acc)
        S = None
        for i in range(q):
            S = _acc(S, H_cols[i] * PH_cols[i])
        if jac_flat is None:
            S = S + S
        inv_S = 1.0 / S
        ld = ld - 0.5 * jnp.sum(z * z * inv_S + jnp.log(S) + _LOG2PI,
                                axis=0, keepdims=True)
        gain = [PH_cols[i] * inv_S for i in range(q)]
        mf_cols = [mp_cols[i] + gain[i] * z for i in range(q)]
        IKW = [[(1.0 if i == j else 0.0) - gain[i] * H_cols[j]
                for j in range(q)] for i in range(q)]
        pf_cols = _sym_quadform(q, IKW, pp_cols, where)
        if jac_flat is None:
            V = S * 0.5
            pf_cols = [pf_cols[k] + gain[i] * gain[j] * V
                       for k, (i, j) in enumerate(pairs)]
        if with_obs:
            PD = []
            for i in range(q):
                acc = None
                for j in range(q):
                    term = p_cols_at(pf_cols, where, i, j) * D[j]
                    acc = term if acc is None else acc + term
                PD.append(acc)
            So = om
            for i in range(q):
                So = So + D[i] * PD[i]
            zo = y
            for i in range(q):
                zo = zo - D[i] * mf_cols[i]
            inv_So = 1.0 / So
            logp = -0.5 * jnp.sum(zo * zo * inv_So + jnp.log(So) + _LOG2PI,
                                  axis=0, keepdims=True)
            ld = ld + mask * logp
            K = [PD[i] * inv_So * mask for i in range(q)]
            mf_cols = [mf_cols[i] + K[i] * zo for i in range(q)]
            IKD = [[(1.0 if i == j else 0.0) - K[i] * D[j]
                    for j in range(q)] for i in range(q)]
            pj = _sym_quadform(q, IKD, pf_cols, where)
            pf_cols = [pj[kk] + K[i] * K[j] * om
                       for kk, (i, j) in enumerate(pairs)]
        return tuple(mf_cols), tuple(pf_cols), ld

    return step


def _dalton_prepare(thetas, ode_weight, ode_inits, t_min, t_max, n_steps,
                    prior_pars, obs_data, obs_times, obs_weight, obs_var,
                    caller):
    """Shared scaled-coordinate / observation-grid setup for the fused
    DALTON entry points (primal and tangent-augmented)."""
    n_lane = thetas.shape[0]
    n_block, n_bmeas, q = ode_weight.shape
    n_obs, _, n_bobs, _ = obs_weight.shape
    if n_bmeas != 1 or n_bobs != 1:
        raise NotImplementedError(
            f"{caller} requires n_bmeas == n_bobs == 1")
    pairs, _ = _tri_idx(q)
    n_tri = len(pairs)
    dt = (t_max - t_min) / n_steps
    t_vec = taylor_scale(dt, q, dtype=jnp.float32)
    Qs, Rs = scale_prior(prior_pars, t_vec)
    q_const = _static_scaled_qconst(prior_pars[0], dt, q)
    if q_const is None:
        raise NotImplementedError(
            f"{caller} requires a block-constant transition "
            "available at trace time (a concrete block-constant "
            "prior, e.g. ibm_init, built/cast OUTSIDE jit — an "
            "astype/scale applied inside a jitted closure turns it "
            "into a tracer)")
    W_s = (ode_weight * t_vec[None, None, :])[:, 0, :]
    x0_lanes = jnp.transpose(
        (ode_inits / t_vec).astype(jnp.float32), (2, 1, 0))
    tgrid = t_min + (t_max - t_min) * (jnp.arange(n_steps) + 1) / n_steps
    theta_lanes = jnp.transpose(thetas).astype(jnp.float32)

    # observation model on the grid; NB: the reference matches obs to step
    # t via `t + 1 == obs_ind[i]`, i.e. the mask lives on steps 1..N
    sim_times = jnp.linspace(t_min, t_max, n_steps + 1)
    obs_ind = jnp.searchsorted(sim_times, obs_times)
    D_scaled = (obs_weight[:, :, 0, :]
                * t_vec.astype(obs_weight.dtype)).astype(jnp.float32)
    d_grid = jnp.zeros((n_steps + 1, n_block, q), jnp.float32)
    d_grid = d_grid.at[obs_ind].set(D_scaled)
    y_grid = jnp.zeros((n_steps + 1, n_block, 1), jnp.float32)
    y_grid = y_grid.at[obs_ind].set(obs_data[:, :, :1].astype(jnp.float32))
    om_grid = jnp.ones((n_steps + 1, n_block, 1), jnp.float32)
    om_grid = om_grid.at[obs_ind].set(
        obs_var[:, :, 0, :1].astype(jnp.float32))
    mask_grid = jnp.zeros((n_steps + 1, 1), jnp.float32)
    mask_grid = mask_grid.at[obs_ind, 0].set(1.0)
    d_k = jnp.transpose(d_grid[1:], (0, 2, 1))[..., None]
    y_k = jnp.transpose(y_grid[1:], (0, 2, 1))[..., None]
    om_k = jnp.transpose(om_grid[1:], (0, 2, 1))[..., None]
    mask_k = mask_grid[1:, 0]

    # masked t = 0 observation term: log p(Y_0 | X_0) (batched, host-side;
    # original coordinates, so the original obs weight — not the scaled one)
    x0_orig = jnp.transpose(ode_inits, (1, 2, 0)).astype(jnp.float32)
    D0 = obs_weight[0, :, 0, :].astype(jnp.float32)      # (nb, q)
    mean_y0 = jnp.einsum("nq,nqb->nb", D0, x0_orig)      # (nb, B)
    z0 = y_grid[0] - mean_y0
    ld0 = mask_grid[0, 0] * (-0.5) * jnp.sum(
        z0 * z0 / om_grid[0] + jnp.log(om_grid[0]) + _LOG2PI, axis=0,
        keepdims=True)
    return (n_lane, n_block, q, n_tri, pairs, q_const, Rs, W_s, x0_lanes,
            tgrid, t_vec, theta_lanes, d_k, y_k, om_k, mask_k, ld0)

def _dalton_run(prep, ode_flat, jac_flat, with_obs, n_tan, ld_seed):
    """One DALTON filter pass over time: the pure step of
    :func:`_dalton_step_pure` on the primal state plus ``n_tan`` tangent
    copies (one `jax.jvp` per theta basis direction).  Returns the
    accumulated log-density rows ``(1 + n_tan, n_lane)``."""
    (n_lane, n_block, q, n_tri, pairs, q_const, Rs, W_s, x0_lanes,
     tgrid, t_vec, theta_lanes, d_k, y_k, om_k, mask_k, _) = prep
    _, where = _tri_idx(q)
    R_packed = _pack_tri(Rs, pairs).astype(jnp.float32)
    W = W_s.astype(jnp.float32)
    R_cols = [R_packed[:, k:k + 1] for k in range(n_tri)]
    W_cols = [W[:, j:j + 1] for j in range(q)]
    tv_cols = [t_vec[j] for j in range(q)]
    th_val = theta_lanes
    n_theta = th_val.shape[0]
    dths = [jnp.concatenate([jnp.ones_like(th_val[0:1]) if i == k
                             else jnp.zeros_like(th_val[0:1])
                             for i in range(n_theta)], axis=0)
            for k in range(n_tan)]

    def step(carry, x_t):
        m_aug, p_aug, ld_aug = carry
        t_n, D_t, y_t, om_t, mask = x_t
        pure = _dalton_step_pure(
            ode_flat, jac_flat, with_obs, q, where, pairs, q_const,
            R_cols, W_cols, tv_cols, t_n, [D_t[j] for j in range(q)],
            y_t[0], om_t[0], mask)
        args = (tuple(m_aug[:q]), tuple(p_aug[:n_tri]), ld_aug[0:1],
                th_val)
        outs = [pure(*args)]
        for k in range(n_tan):
            tans = (tuple(m_aug[(1 + k) * q:(2 + k) * q]),
                    tuple(p_aug[(1 + k) * n_tri:(2 + k) * n_tri]),
                    ld_aug[1 + k:2 + k], dths[k])
            outs.append(jax.jvp(pure, args, tans)[1])
        return ([c for o in outs for c in o[0]],
                [c for o in outs for c in o[1]],
                jnp.concatenate([o[2] for o in outs], axis=0)), ()

    zero = jnp.zeros((n_block, n_lane), jnp.float32)
    carry0 = (list(x0_lanes) + [zero] * (n_tan * q),
              [zero] * ((1 + n_tan) * n_tri), ld_seed.astype(jnp.float32))
    (_, _, ld), _ = scan_steps(
        step, carry0,
        (tgrid.astype(jnp.float32), d_k, y_k, om_k, mask_k))
    return ld


def dalton_fused_batch(thetas, ode_weight, ode_inits,
                       t_min, t_max, n_steps,
                       prior_pars,
                       obs_data, obs_times, obs_weight, obs_var,
                       ode_flat, jac_flat=None, kalman_type="standard"):
    r"""
    Lane-batched fused DALTON log-likelihood
    :math:`\log p(Y \mid Z) = \log p(Z, Y) - \log p(Z)` — ``n_lane``
    evaluations per pipeline.

    Args and return as :func:`rodeo_tpu.ops.pallas_fenrir.fenrir_fused_batch`
    (``kalman_type``: the value is form-independent; both forms ride the
    same Joseph-form filter, see
    :func:`rodeo_tpu.ops.pallas_kalman.resolve_kalman_type`).
    """
    kalman_type = resolve_kalman_type(kalman_type)
    prior_pars = normalize_prior_pars(kalman_type, prior_pars)
    obs_var = normalize_meas_var(kalman_type, obs_var)
    prep = _dalton_prepare(
        thetas, ode_weight, ode_inits, t_min, t_max, n_steps, prior_pars,
        obs_data, obs_times, obs_weight, obs_var, "dalton_fused_batch")
    ld0, n_lane = prep[-1], prep[0]
    ld_joint = _dalton_run(prep, ode_flat, jac_flat, True, 0, ld0)
    ld_marg = _dalton_run(prep, ode_flat, jac_flat, False, 0,
                          jnp.zeros((1, n_lane), jnp.float32))
    return (ld_joint - ld_marg)[0]


def dalton_fused_batch_grad(thetas, ode_weight, ode_inits,
                            t_min, t_max, n_steps,
                            prior_pars,
                            obs_data, obs_times, obs_weight, obs_var,
                            ode_flat, jac_flat=None, kalman_type="standard"):
    r"""
    Lane-batched fused DALTON log-likelihood AND its theta-gradient via
    forward-mode tangent augmentation (`jax.jvp` of the pure per-step
    update; same trick as
    :func:`rodeo_tpu.ops.pallas_fenrir.fenrir_fused_batch_grad`).
    DALTON stores no per-step state, so the whole augmented computation
    stays inside the two filter passes.

    ``ode_inits`` must not depend on theta (tangent seeded zero).

    Returns:
        (tuple): ``loglik (n_lane,)``, ``grad (n_lane, n_theta)``.
    """
    kalman_type = resolve_kalman_type(kalman_type)
    prior_pars = normalize_prior_pars(kalman_type, prior_pars)
    obs_var = normalize_meas_var(kalman_type, obs_var)
    n_tan = thetas.shape[1]
    prep = _dalton_prepare(
        thetas, ode_weight, ode_inits, t_min, t_max, n_steps, prior_pars,
        obs_data, obs_times, obs_weight, obs_var,
        "dalton_fused_batch_grad")
    ld0, n_lane = prep[-1], prep[0]
    # ld0 is theta-independent (x0 must not depend on theta): tangent rows
    # seed zero
    zeros_tan = jnp.zeros((n_tan, n_lane), jnp.float32)
    ld_joint = _dalton_run(prep, ode_flat, jac_flat, True, n_tan,
                           jnp.concatenate([ld0, zeros_tan], axis=0))
    ld_marg = _dalton_run(prep, ode_flat, jac_flat, False, n_tan,
                          jnp.zeros((1 + n_tan, n_lane), jnp.float32))
    diff = ld_joint - ld_marg
    return diff[0], jnp.transpose(diff[1:])
