r"""
Fused lane-batched posterior sampling (``solve_sim``) and the fast MCMC
step built on it.

The reference's ``solve_sim`` (``solve.py:125-205``) draws a posterior path
by a backward pass of per-step conditionals: given :math:`x_{n+1}`,

.. math::

    x_n \sim N\!\left(m^f_n + G_n (x_{n+1} - m^p_{n+1}),\;
                      P^f_n - G_n P^p_{n+1} G_n'\right),

with :math:`G_n = P^f_n Q' (P^p_{n+1})^{-1}` — the *same* gains as the RTS
smoother.  Decomposition:

1. the lane-batched forward filter
   (:func:`rodeo_tpu.ops.pallas_kalman.fused_filter_batch`) emits the
   gains :math:`(G_n, g_n, L_n)` step by step;
2. the conditional covariance :math:`L_n` is Cholesky-factored in closed
   form (column layout, any ``q``) and the per-step correlated noise
   :math:`\eta_n = L_n^{1/2} \epsilon_n` is precomputed batched — so the
   irreducibly sequential part is only the affine recursion
   :math:`x_n = c_n + G_n x_{n+1}` with :math:`c_n = g_n + \eta_n`;
3. the shared backward mean recursion
   (:func:`rodeo_tpu.ops.pallas_kalman.smoother_mean_recursion_batch_tan`
   with no tangents) runs that recursion: ~``q^2`` FMAs of
   ``(n_block, n_lane)`` tiles per step — a far shorter dependency chain
   than the filter's.
"""
import jax
import jax.numpy as jnp

from rodeo_tpu.ops.precond import taylor_scale, scale_prior
from rodeo_tpu.ops.pallas_kalman import (
    fused_filter_batch, smoother_mean_recursion_batch_tan, _tri_idx,
    _static_scaled_qconst, _chol_cols, _chol_matvec)

__all__ = ["solve_sim_fused_batch"]


def solve_sim_fused_batch(key, thetas, ode_weight, ode_inits,
                          t_min, t_max, n_steps,
                          prior_pars,
                          ode_flat, jac_flat=None,
                          interrogation=None, kalman_type="standard"):
    r"""
    Lane-batched fused posterior path sampling: ``n_lane`` independent
    draws (one per parameter candidate / MCMC chain) in one pipeline.
    Distributionally matches
    :func:`rodeo_tpu.ops.precond.solve_sim` per lane (standard filter,
    EK0/EK1 interrogations); the PRNG stream differs from the reference's
    per-step key-split tree.

    Args:
        key (PRNGKey): PRNG key for the path noise.
        thetas (ndarray(n_lane, n_theta)): Per-lane parameters.
        ode_inits (ndarray(n_lane, n_block, q)): Per-lane initial states
            (original coordinates).
        (other args as
        :func:`rodeo_tpu.ops.pallas_kalman.solve_mv_fused_batch`)

    Returns:
        (ndarray(n_steps+1, n_block, q, n_lane)): Sampled solution paths,
        lane axis last (original coordinates).
    """
    from rodeo_tpu.ops.pallas_kalman import (resolve_kalman_type,
                                             normalize_prior_pars)
    # draws are distribution-level, determined by the propagated
    # covariances: form-independent
    kalman_type = resolve_kalman_type(kalman_type)
    prior_pars = normalize_prior_pars(kalman_type, prior_pars)
    n_lane = thetas.shape[0]
    n_block, n_bmeas, q = ode_weight.shape
    if n_bmeas != 1:
        raise NotImplementedError("fused solvers require n_bmeas == 1")
    pairs, where = _tri_idx(q)
    n_tri = len(pairs)
    dt = (t_max - t_min) / n_steps
    t_vec = taylor_scale(dt, q, dtype=jnp.float32)
    Qs, Rs = scale_prior(prior_pars, t_vec)
    q_const = _static_scaled_qconst(prior_pars[0], dt, q)
    if q_const is None:
        raise NotImplementedError(
            "solve_sim_fused_batch requires a block-constant transition "
            "available at trace time (a concrete block-constant "
            "prior, e.g. ibm_init, built/cast OUTSIDE jit — an "
            "astype/scale applied inside a jitted closure turns it "
            "into a tracer)")
    W_s = (ode_weight * t_vec[None, None, :])[:, 0, :]
    x0_lanes = jnp.transpose(
        (ode_inits / t_vec).astype(jnp.float32), (2, 1, 0))   # (q, nb, B)
    tgrid = t_min + (t_max - t_min) * (jnp.arange(n_steps) + 1) / n_steps
    theta_lanes = jnp.transpose(thetas).astype(jnp.float32)

    eps_int = None
    if interrogation == "chkrebtii":
        key, key_int = jax.random.split(key)
        eps_int = jax.random.normal(
            key_int, (n_steps, q, n_block, n_lane), jnp.float32)
    # forward filter emitting the conditional-draw gains for steps
    # 1..N-1 (entry 0 conditions onto the Dirac init and is not sampled);
    # the final filtered state seeds the terminal draw
    A_k3, b_k3, C_k3, m_last, p_last = fused_filter_batch(
        ode_flat, jac_flat, n_steps, Qs, Rs, W_s, x0_lanes,
        theta_lanes, tgrid, t_vec, raw_q_const=q_const,
        mode=interrogation, eps=eps_int,
        emit="gains")
    G = [[A_k3[1:, i * q + j] for j in range(q)] for i in range(q)]
    g = [b_k3[1:, i] for i in range(q)]
    L = [C_k3[1:, k] for k in range(n_tri)]

    # correlated per-step noise + terminal draw, batched
    n_len = n_steps - 1
    key_path, key_term = jax.random.split(key)
    eps = jax.random.normal(key_path, (n_len, q, n_block, n_lane),
                            jnp.float32)
    Lc = _chol_cols(q, L, where)
    eta = _chol_matvec(q, Lc, [eps[:, j] for j in range(q)])
    c_cols = [g[i] + eta[i] for i in range(q)]

    epsN = jax.random.normal(key_term, (q, n_block, n_lane), jnp.float32)
    pN_cols = [p_last[k] for k in range(n_tri)]
    LN = _chol_cols(q, pN_cols, where)
    etaN = _chol_matvec(q, LN, [epsN[j] for j in range(q)])
    xN = jnp.stack([m_last[j] + etaN[j] for j in range(q)])   # (q, nb, B)

    # the affine recursion right to left
    c_k = jnp.stack(c_cols, axis=1).astype(jnp.float32)
    G_k = jnp.stack([G[i][j] for i in range(q) for j in range(q)],
                    axis=1).astype(jnp.float32)
    xs = smoother_mean_recursion_batch_tan(c_k, G_k, xN, 0)

    # assemble (N+1, nb, q, B) in original coordinates, lanes last
    t_col = t_vec.astype(jnp.float32)[:, None]                # (q, 1)
    path = jnp.concatenate([
        jnp.transpose(x0_lanes, (1, 0, 2))[None],             # (1, nb, q, B)
        jnp.transpose(xs, (0, 2, 1, 3)),
        jnp.transpose(xN, (1, 0, 2))[None],
    ], axis=0) * t_col
    return path
