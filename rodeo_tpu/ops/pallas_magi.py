r"""
Fused MAGI log-density (lane-batched).

The MAGI filter (``rodeo_tpu/inference/magi.py``, reference
``src/rodeo/inference/magi.py:21-99``) conditions the Gauss-Markov prior
on *exact* pseudo-observations of the first ``n_active`` derivatives of a
fixed expanded path — there is no interrogation and no ODE callback, so
the whole recursion is a linear Kalman filter whose per-step math unrolls
into constant-coefficient FMAs on ``(n_block, n_lane)`` column registers:

1. predict through the trace-time Pascal transition
   (:func:`rodeo_tpu.ops.pallas_kalman._static_scaled_qconst`);
2. forecast log-density of the active block via the closed-form
   packed-symmetric inverse/determinant (``n_active <= 3``);
3. exact-observation update: the active rows of the state collapse onto
   the data (zero variance), the inactive block is conditioned through
   the gain ``G = P_ia S^{-1}``.

Because the active rows reset to the exact data each step, float32
rounding cannot accumulate in the observed components.

Lane axis = independent path/parameter candidates (MCMC chains over
``(U, \theta)``); per-lane prior noise scale enters as an optional
``sig2_lanes`` multiplier on the scaled process noise.
"""
import math

import jax
import jax.numpy as jnp

from rodeo_tpu.ops.precond import taylor_scale, scale_prior
from rodeo_tpu.ops.pallas_kalman import (
    _tri_idx, _pack_tri, _sym_quadform, _sym_inv, _matvec,
    _static_scaled_qconst)
from rodeo_tpu.ops.scan import scan_steps

__all__ = ["magi_fused_batch", "magi_fused_batch_grad"]

_LOG2PI = 1.8378770664093453


def _sym_det(a, S_cols):
    """Determinant of a packed-symmetric column matrix, a <= 3 (scaled
    coordinates keep it O(1), so no overflow normalization needed)."""
    if a == 1:
        return S_cols[0]
    if a == 2:
        s00, s01, s11 = S_cols
        return s00 * s11 - s01 * s01
    if a == 3:
        s00, s01, s02, s11, s12, s22 = S_cols
        return (s00 * (s11 * s22 - s12 * s12)
                - s01 * (s01 * s22 - s12 * s02)
                + s02 * (s01 * s12 - s11 * s02))
    raise NotImplementedError("magi_fused_batch supports n_active <= 3")

def _magi_step(q, act, q_const, R_cols, emit):
    """One MAGI filter step ``step((m, P, ld), x_t)`` with ``x_t`` the
    step's active path rows ``(act, nb, B)``: predict, accumulate the
    forecast log-density of the active block, condition exactly on it.

    ``emit="adjoint"`` also emits the per-step innovation ``z``, packed
    forecast inverse ``S^{-1}`` and (for ``q > act``) conditioning gain
    ``G`` — the (data-independent-coefficient) inputs of the exact adjoint
    recursion of :func:`_magi_adjoint_step`."""
    pairs, where = _tri_idx(q)
    pairs_a, where_a = _tri_idx(act)
    n_tri = len(pairs)

    def step(carry, x_t):
        m_cols, p_cols, ld = carry
        mp = _matvec(q, q_const, m_cols)
        app = _sym_quadform(q, q_const, p_cols, where)
        pp = [app[k] + R_cols[k] for k in range(n_tri)]
        # forecast log-density of the active block (exact Gaussian;
        # reference magi.py:70-74 uses the non-masked logpdf)
        S_cols = [pp[where[(i, j)]] for (i, j) in pairs_a]
        z = [x_t[j] - mp[j] for j in range(act)]
        invS = _sym_inv(act, S_cols)
        quad = None
        for i in range(act):
            for j in range(act):
                term = z[i] * invS[where_a[(i, j)]] * z[j]
                quad = term if quad is None else quad + term
        det = _sym_det(act, S_cols)
        ld = ld - 0.5 * jnp.sum(quad + jnp.log(det) + act * _LOG2PI,
                                axis=0, keepdims=True)
        # exact-observation update: active rows collapse onto the data;
        # inactive block conditioned via G = P_ia S^{-1}
        G = [[None] * act for _ in range(q)]
        for i in range(act, q):
            for a in range(act):
                acc = None
                for b in range(act):
                    term = pp[where[(i, b)]] * invS[where_a[(b, a)]]
                    acc = term if acc is None else acc + term
                G[i][a] = acc
        m_out = [x_t[j] for j in range(act)]
        for i in range(act, q):
            acc = mp[i]
            for a in range(act):
                acc = acc + G[i][a] * z[a]
            m_out.append(acc)
        zero = jnp.zeros_like(mp[0])
        p_out = []
        for kk, (i, j) in enumerate(pairs):
            if i < act or j < act:
                p_out.append(zero)
            else:
                acc = pp[kk]
                for a in range(act):
                    acc = acc - G[i][a] * pp[where[(a, j)]]
                p_out.append(acc)
        outs = ()
        if emit == "adjoint":
            outs = (z, invS)
            if q > act:
                outs += ([G[i][a] for i in range(act, q)
                          for a in range(act)],)
        return (m_out, p_out, ld), outs

    return step


def magi_fused_batch(ode_data_subsets, ode_expand, n_active, prior_pars,
                     dt, sig2_lanes=None, **params):
    r"""
    Lane-batched fused MAGI log-density: ``n_lane`` independent paths
    evaluated in one pipeline.  Same value per lane as
    :func:`rodeo_tpu.ops.precond.magi_logdens` up to float32 rounding.

    Args:
        ode_data_subsets (ndarray(n_lane, n_steps+1, n_block, n_sub)):
            Per-lane path subsets (leading lane axis over the plain API's
            ``ode_data_subset``).
        ode_expand (Callable): ``ode_expand(subset, **params)`` mapping
            one subset to the full ``(n_steps+1, n_block, n_deriv)``
            state (vmapped over lanes here; ``params`` shared).
        n_active (int): Number of exactly-observed derivatives
            (``<= 3``).
        prior_pars (tuple): Unscaled ``(prior_weight, prior_var)`` with a
            block-constant transition available at trace time.
        dt (float): Solver step size (builds the Taylor scaling).
        sig2_lanes (ndarray(n_lane,) | None): Optional per-lane
            multiplier on the process-noise variance (e.g. a sampled
            :math:`\sigma^2` relative to the one baked into
            ``prior_pars``).

    Returns:
        (ndarray(n_lane,)): Log-density values.
    """
    expand = jax.vmap(lambda u: ode_expand(u, **params))
    paths = expand(ode_data_subsets)                 # (B, N+1, nb, q)
    ld, _ = _magi_forward(paths, int(n_active), prior_pars, dt,
                          sig2_lanes, emit="ld")
    return ld


def _magi_jacobian(dt, t_vec, n_steps, n_block, q, act):
    """Change-of-variables constant back from scaled coordinates (exact
    trace-time constant when dt is static; matches
    :func:`rodeo_tpu.ops.precond.magi_logdens`)."""
    qd = q - 1
    try:
        dt_f = float(dt)
        tv = [math.sqrt(dt_f) * dt_f ** (qd - i) / math.factorial(qd - i)
              for i in range(q)]
        return jnp.float32(
            n_steps * n_block * sum(math.log(t) for t in tv[:act]))
    except TypeError:  # traced dt
        return (n_steps * n_block
                * jnp.sum(jnp.log(t_vec[:act]))).astype(jnp.float32)

def _magi_forward(paths, act, prior_pars, dt, sig2_lanes, emit):
    """Shared forward driver over pre-expanded paths.

    Returns ``(ld, aux)`` where ``aux`` is ``None`` for ``emit="ld"`` and
    ``(z_k, s_k, gG_k, t_vec)`` for ``emit="adjoint"`` (``gG_k`` is
    ``None`` when ``q == act``)."""
    n_lane, n_tot, n_block, q = paths.shape
    n_steps = n_tot - 1
    if act > min(3, q):
        raise NotImplementedError(
            "magi_fused_batch supports n_active <= 3 (and <= n_deriv)")
    pairs, _ = _tri_idx(q)
    n_tri = len(pairs)
    q_const = _static_scaled_qconst(prior_pars[0], dt, q)
    if q_const is None:
        raise NotImplementedError(
            "magi_fused_batch requires a block-constant transition "
            "available at trace time (a concrete block-constant "
            "prior, e.g. ibm_init, built/cast OUTSIDE jit — an "
            "astype/scale applied inside a jitted closure turns it "
            "into a tracer)")
    t_vec = taylor_scale(dt, q, dtype=jnp.float32)
    _, Rs = scale_prior(tuple(jnp.asarray(a, jnp.float32)
                              for a in prior_pars), t_vec)
    R_k = jnp.transpose(_pack_tri(Rs, pairs))[..., None]   # (n_tri, nb, 1)
    if sig2_lanes is not None:
        R_k = R_k * jnp.asarray(sig2_lanes, jnp.float32)[None, None, :]
    paths_s = (paths / t_vec).astype(jnp.float32)
    # layouts: x (N, act, nb, B); seed mean (q, nb, B)
    x_k = jnp.transpose(paths_s[:, 1:, :, :act], (1, 3, 2, 0))
    m0 = jnp.transpose(paths_s[:, 0], (2, 1, 0))
    step = _magi_step(q, act, q_const, list(R_k.astype(jnp.float32)),
                      emit)
    carry0 = (list(m0), [jnp.zeros_like(m0[0])] * n_tri,
              jnp.zeros((1, n_lane), jnp.float32))
    (_, _, ld), outs = scan_steps(step, carry0, x_k)
    jacobian = _magi_jacobian(dt, t_vec, n_steps, n_block, q, act)
    ld = ld[0] - jacobian
    if emit != "adjoint":
        return ld, None
    gG_k = outs[2] if q > act else None
    return ld, (outs[0], outs[1], gG_k, t_vec)


def _magi_adjoint_step(q, act, q_const):
    """One step of the exact adjoint of the MAGI filter log-density
    w.r.t. the (scaled) path data.

    The filter's covariance recursion never sees the data, so the adjoint
    is a linear backward recursion with the coefficients the forward pass
    emitted: per step ``r`` (with ``lam_r = dL/dm_r``, seeded
    ``lam_N = 0``)

    .. code-block:: text

        v = S^{-1} z                 (forecast-density term)
        t_a = sum_{i>=act} G[i][a] lam[i]
        dL/dx_r  = lam[:act] + t - v
        lam_{r-1} = Q' [ v - t ; lam[act:] ]

    and ``dL/dm_0 = lam_0`` covers the full ``q``-row seed state.
    """
    _, where_a = _tri_idx(act)
    qT = [[q_const[i][j] for i in range(q)] for j in range(q)]

    def step(lam, x_t):
        z_t, s_t, gG_t = x_t
        z = [z_t[j] for j in range(act)]
        v = []
        for a in range(act):
            acc = None
            for b in range(act):
                term = s_t[where_a[(a, b)]] * z[b]
                acc = term if acc is None else acc + term
            v.append(acc)
        zero = jnp.zeros_like(z[0])
        t = [zero] * act
        if gG_t is not None:
            for a in range(act):
                acc = None
                for i in range(act, q):
                    term = gG_t[(i - act) * act + a] * lam[i]
                    acc = term if acc is None else acc + term
                t[a] = acc
        gx = [lam[a] + t[a] - v[a] for a in range(act)]
        u = [v[a] - t[a] for a in range(act)] + [lam[i]
                                                 for i in range(act, q)]
        lam_new = _matvec(q, qT, u)
        return [c if c is not None else zero for c in lam_new], (gx,)

    return step


def magi_fused_batch_grad(ode_data_subsets, ode_expand, n_active,
                          prior_pars, dt, theta_lanes=None,
                          sig2_lanes=None, **params):
    r"""
    Fused MAGI log-density **and its exact gradient w.r.t. the path**
    (and optionally per-lane parameters), lane-batched.

    MAGI's MCMC/MAP state is the whole latent path :math:`U_{0:N}` —
    thousands of dimensions — so the forward-mode tangent trick of the
    other ``*_fused_batch_grad`` entries cannot scale here.  Instead this
    runs reverse mode natively: the MAGI filter is linear-Gaussian in the
    expanded path (covariances/gains never see the data), so its adjoint
    is a constant-coefficient backward recursion.  The forward pass
    additionally emits per-step ``(z, S^{-1}, G)``; a second pass runs
    the adjoint; the chain rule through ``ode_expand`` (and the Taylor
    scaling) is one ``jax.vjp``.  Cost: ~2x the value-only pass.

    Parity: matches ``jax.grad`` of
    :func:`rodeo_tpu.ops.precond.magi_logdens` (reference semantics,
    upstream ``src/rodeo/inference/magi.py:21-99``) to float32 accuracy.

    Args:
        theta_lanes (ndarray(n_lane, ...) pytree | None): Optional
            per-lane parameters; when given, ``ode_expand`` is called as
            ``ode_expand(subset, theta=theta_lane, **params)`` and the
            gradient w.r.t. ``theta_lanes`` is returned as well.
        sig2_lanes: As in :func:`magi_fused_batch`; supported in the
            value and in the path/theta gradients, but **no gradient
            w.r.t.** ``sig2_lanes`` is returned (its derivative flows
            through the covariance recursion; use a Gibbs/marginal move
            for :math:`\sigma^2`).
        (other arguments as :func:`magi_fused_batch`)

    Returns:
        (tuple): ``(ld (n_lane,), grad_subsets)`` — plus
        ``grad_theta`` when ``theta_lanes`` is given.
    """
    act = int(n_active)
    if theta_lanes is None:
        expand = lambda U: jax.vmap(
            lambda u: ode_expand(u, **params))(U)
        paths, vjp_fn = jax.vjp(expand, ode_data_subsets)
    else:
        expand = lambda U, TH: jax.vmap(
            lambda u, th: ode_expand(u, theta=th, **params))(U, TH)
        paths, vjp_fn = jax.vjp(expand, ode_data_subsets, theta_lanes)
    n_lane, n_tot, n_block, q = paths.shape
    n_steps = n_tot - 1
    ld, aux = _magi_forward(paths, act, prior_pars, dt, sig2_lanes,
                            emit="adjoint")
    z_k, s_k, gG_k, t_vec = aux
    step = _magi_adjoint_step(q, act,
                              _static_scaled_qconst(prior_pars[0], dt, q))
    lam0, (gx,) = scan_steps(step, [jnp.zeros_like(z_k[0, 0])] * q,
                             (z_k, s_k, gG_k), reverse=True)
    lam0 = jnp.stack(lam0)
    # assemble d ld / d paths (original coordinates) and pull back
    # through ode_expand;  paths_s = paths / t_vec  =>  divide again
    g_s = jnp.zeros((n_lane, n_tot, n_block, q), jnp.float32)
    g_s = g_s.at[:, 1:, :, :act].set(jnp.transpose(gx, (3, 0, 2, 1)))
    g_s = g_s.at[:, 0].set(jnp.transpose(lam0, (2, 1, 0)))
    g_paths = (g_s / t_vec).astype(paths.dtype)
    grads = vjp_fn(g_paths)
    if theta_lanes is None:
        return ld, grads[0]
    return ld, grads[0], grads[1]
