r"""
Stationary-gain dense solver and likelihoods for linear/affine ODEs.

For a time-invariant *affine* ODE (state-independent Jacobian — e.g. any
linear PDE semi-discretization, :mod:`rodeo_tpu.models.heat`) with a
deterministic interrogation, the measurement model of the probabilistic
solver is one fixed affine map :math:`h(m) = H m + b`, so the Kalman
covariance recursion is a Riccati iteration that converges to its fixed
point within tens of steps.  This module exploits that:

1. run the exact covariance/Riccati recursion for ``n_warm`` steps and
   freeze the converged filter gain, predicted/filtered covariances and
   smoothing gain;
2. propagate the *means* over all ``n_steps`` with cheap matvec scans
   (the :math:`O(n^3)` per-step covariance matmuls and the innovation
   Cholesky drop out of the time loop entirely);
3. reconstruct smoothed covariances from the three regimes they actually
   occupy: the exact ``n_warm`` head transient, the converged interior
   plateau, and the terminal backward transient (computed by iterating
   the frozen smoother recursion).

:func:`solve_mv_stationary` is the solver; :func:`fenrir_stationary` is
the matching data likelihood (parameter inference in the large-state
regime): the fenrir backward pass only needs covariances *at the
observation rows*, and between observations the backward-filter
covariance evolves under the single frozen affine map
:math:`\Phi(P) = A P A' + C`, whose ``g``-step composition is computed in
:math:`O(\log g)` matmuls by operator doubling — so the whole backward
covariance pass costs :math:`O(n_{\text{warm}} + M \log g)` matrix ops
for :math:`M` observations instead of :math:`O(N)`.

This is the dense/XLA analogue of the lane-fused
:func:`rodeo_tpu.ops.pallas_kalman.solve_mv_fused_stationary` (which
covers the small-q blocked regime), aimed at the large-state regime
where each covariance step is a set of large matmuls.  At ``d=128``
(state dim 384, ``n_steps=1000``) it cuts the 1000-step covariance work
to ``2 n_warm`` steps.

VALIDITY: the ODE right-hand side must be affine in the state with
time-constant coefficients, and ``interrogate`` must be deterministic
(kramer/rodeo/tronarp — anything that ignores ``key`` and
``var_state_pred``'s randomness).  For kramer (EK1) on an affine RHS the
result equals the exact path up to the frozen-tail approximation
(:math:`\rho^{n_{\text{warm}}}` with :math:`\rho < 1` the steady-state
closed-loop spectral radius); nonlinear RHSs are NOT supported — use
:func:`rodeo_tpu.ops.precond.solve_mv`.

Reference context: the reference library has no stationary path at all
(upstream ``rodeo/solve.py`` runs the full recursion unconditionally,
and its fenrir backward pass at upstream
``rodeo/inference/fenrir.py:86-259`` re-derives the backward kernel at
every step); this module is new surface.
"""
import numpy as np
import jax
import jax.numpy as jnp

from rodeo_tpu.utils import mtt, mvdot, quadform, \
    multivariate_normal_logpdf
from rodeo_tpu.ops.linalg import fast_linalg, solve_psd
from rodeo_tpu.ops.linalg import full_matmul_precision
from rodeo_tpu.ops.precond import _scaled_inputs, _wrap_interrogate
from rodeo_tpu.ops.scan import scan as _uscan

__all__ = ["solve_mv_stationary", "fenrir_stationary",
           "dalton_stationary", "daltonng_stationary"]


def _warn_nonaffine(badness):
    """``badness`` = probe residual over its scale/noise-aware threshold
    (see ``_extract_affine``); > 1 means the contract check failed."""
    import warnings
    if float(badness) > 1.0:
        warnings.warn(
            "solve_mv_stationary: the extracted affine measurement map "
            f"disagrees with the real interrogation ({float(badness):.1f}"
            "x the probe tolerance) — the ODE right-hand side appears "
            "nonlinear or time-varying, which violates this solver's "
            "validity contract; the returned posterior is unreliable "
            "(and is NaN-poisoned).  Use rodeo_tpu.ops.precond.solve_mv "
            "instead (or pass validate=False to silence a false alarm).",
            RuntimeWarning, stacklevel=2)


def _sym(a):
    return 0.5 * (a + jnp.swapaxes(a, -1, -2))


def _stationary_filter(Q, R, H, H_inn, b, v_fun, x0_s, n_steps, n_warm):
    r"""Scaled-coordinate stationary forward filter.

    Riccati warm-up (exact covariance recursion for ``n_warm`` steps,
    then frozen), frozen-gain forward mean scans over all ``n_steps``,
    and the smoothing/backward-chain gains.  Shared by
    :func:`solve_mv_stationary` (which continues with the smoothing
    recursions) and :func:`fenrir_stationary` (which continues with the
    data-conditioned backward pass).

    All of ``Q, R`` (prior), ``H`` (measurement matrix driving the
    gain/covariances — ``W + wgt_meas`` exactly as the sequential filter
    sees it), ``H_inn, b`` (the affine innovation map — equal to ``H``
    for EK1/kramer, but ``W - F`` vs ``H = W`` for EK0/rodeo, where the
    Jacobian enters through ``mean_meas`` only), ``x0_s`` are blocked
    ``(n_block, ...)`` arrays; ``v_fun(P_pred) -> var_meas`` reproduces
    the interrogation's measurement noise, which must be AFFINE in the
    predicted variance (kramer: constant zero; rodeo: ``W Σ W'``) — the
    constant part is hoisted out of the warm-up scan and only its
    JVP-derived linear action stays per-step.

    Returns a dict with (indices are grid rows; ``*_pre`` arrays cover
    the warm prefix):

    - ``P_p_pre (n_warm, nb, n, n)``: predicted covariance at rows
      ``1..n_warm``; ``P_f_pre``: filtered covariance at the same rows;
      ``P_f_km1``: filtered covariance at rows ``0..n_warm-1``
      (``P_f_km1[0] = 0``, the exact init); ``K_pre``: filter gains.
    - ``P_p_st, P_f_st, K_st``: the frozen (converged) values.
    - ``B_pre (n_warm, nb, n, n)``: smoothing/backward-chain gains
      :math:`A_k = P_f[k]\,Q'\,P_p[k+1]^{-1}` for ``k = 0..n_warm-1``;
      ``B_st``: the frozen gain.
    - ``m_f_all (n_steps+1, nb, n)``: filtered means at rows ``0..N``;
      ``m_p_all (n_steps, nb, n)``: predicted means at rows ``1..N``
      (``m_p_all[k]`` is the prediction at row ``k+1``).
    """
    nb, n = x0_s.shape
    dtype = x0_s.dtype
    eye = jnp.broadcast_to(jnp.eye(n, dtype=dtype), (nb, n, n))
    n_tail = n_steps - n_warm

    # --- Riccati warm-up: exact covariance recursion ---------------------
    # V(P) is affine in the predicted variance by the validity contract
    # (kramer: constant zero; rodeo: W P W').  Hoist the constant part
    # out of the scan and keep only the JVP-derived linear part in-step —
    # re-running the full interrogation (jacfwd included) per step costs
    # ~100x the Riccati algebra at state dim 384, and XLA does not
    # hoist it out of the scan body itself.
    P_zero = jnp.zeros((nb, n, n), dtype=dtype)
    V0 = v_fun(P_zero)
    v_lin = lambda P: jax.jvp(v_fun, (P_zero,), (P,))[1]  # noqa: E731

    def ric_step(P_f, _):
        P_p = _sym(quadform(Q, P_f) + R)
        V = V0 + v_lin(P_p)
        S = _sym(quadform(H, P_p) + V)
        K = mtt(solve_psd(S, H @ P_p))
        ikw = eye - K @ H
        # Joseph form: PSD-preserving under f32 cancellation
        P_f_new = _sym(quadform(ikw, P_p) + quadform(K, V))
        return P_f_new, (P_p, P_f_new, K)

    P_f0 = jnp.zeros((nb, n, n), dtype=dtype)
    _, (P_p_pre, P_f_pre, K_pre) = jax.lax.scan(
        ric_step, P_f0, None, length=n_warm)
    P_p_st, P_f_st, K_st = P_p_pre[-1], P_f_pre[-1], K_pre[-1]

    # --- forward means: matvec-only scans --------------------------------
    def mean_step(m_f, K_k):
        m_p = mvdot(Q, m_f)
        m_f_new = m_p - mvdot(K_k, mvdot(H_inn, m_p) + b)
        return m_f_new, (m_p, m_f_new)

    m_f_warm, (m_p_pre, m_f_pre) = jax.lax.scan(mean_step, x0_s, K_pre)
    _, (m_p_tail, m_f_tail) = _uscan(
        lambda m, _: mean_step(m, K_st), m_f_warm, None, length=n_tail)

    # full grids: index 0..N (0 = the exact initial state)
    m_f_all = jnp.concatenate([x0_s[None], m_f_pre, m_f_tail], axis=0)
    m_p_all = jnp.concatenate([m_p_pre, m_p_tail], axis=0)  # steps 1..N

    # --- smoothing gains: B_k = P_f[k] Q' P_p[k+1]^{-1} -------------------
    # prefix: P_f at k = 0..n_warm-1 (P_f[0] = 0), P_p at k+1 = 1..n_warm
    P_f_km1 = jnp.concatenate([P_f0[None], P_f_pre[:-1]], axis=0)
    B_pre = mtt(solve_psd(P_p_pre, Q @ P_f_km1))
    B_st = mtt(solve_psd(P_p_st, Q @ P_f_st))

    return dict(
        P_p_pre=P_p_pre, P_f_pre=P_f_pre, P_f_km1=P_f_km1, K_pre=K_pre,
        P_p_st=P_p_st, P_f_st=P_f_st, K_st=K_st,
        B_pre=B_pre, B_st=B_st,
        m_f_all=m_f_all, m_p_all=m_p_all,
    )


@full_matmul_precision
def _stationary_core(Q, R, H, H_inn, b, v_fun, x0_s, n_steps, n_warm,
                     var_mode="full"):
    """Scaled-coordinate stationary filter+smoother (see
    :func:`_stationary_filter` for the argument contract).  Returns
    smoothed ``(mean (N+1, nb, n), var (N+1, nb, n, n))`` in scaled
    coordinates."""
    nb, n = x0_s.shape
    n_tail = n_steps - n_warm
    n_term = min(n_warm, n_tail)

    f = _stationary_filter(Q, R, H, H_inn, b, v_fun, x0_s, n_steps, n_warm)
    P_p_pre, P_f_km1 = f["P_p_pre"], f["P_f_km1"]
    P_p_st, P_f_st = f["P_p_st"], f["P_f_st"]
    B_pre, B_st = f["B_pre"], f["B_st"]
    m_f_all, m_p_all = f["m_f_all"], f["m_p_all"]

    # --- backward means ---------------------------------------------------
    def smooth_step(m_s, xs):
        m_f_k, m_p_k1, B_k = xs
        m_s_new = m_f_k + mvdot(B_k, m_s - m_p_k1)
        return m_s_new, m_s_new

    # tail region k = N-1 .. n_warm (frozen B_st)
    m_s_at_N = m_f_all[n_steps]
    m_s_boundary, m_s_tail_rev = _uscan(
        lambda m, xs: smooth_step(m, (xs[0], xs[1], B_st)),
        m_s_at_N,
        (m_f_all[n_warm:n_steps][::-1], m_p_all[n_warm:n_steps][::-1]))
    # head region k = n_warm-1 .. 0 (exact prefix gains)
    _, m_s_head_rev = jax.lax.scan(
        smooth_step, m_s_boundary,
        (m_f_all[:n_warm][::-1], m_p_all[:n_warm][::-1], B_pre[::-1]))
    mean_out = jnp.concatenate([
        m_s_head_rev[::-1], m_s_tail_rev[::-1], m_s_at_N[None]], axis=0)

    # --- smoothed covariances: three regimes ------------------------------
    if var_mode == "none":
        return mean_out, None

    # terminal transient, k = N-1 .. N-n_term (frozen recursion from P_f_st)
    def var_step_frozen(Vk, _):
        Vn = _sym(P_f_st + quadform(B_st, Vk - P_p_st))
        return Vn, Vn

    V_interior, V_term_rev = jax.lax.scan(
        var_step_frozen, P_f_st, None, length=n_term)
    # head transient, k = n_warm-1 .. 0 (exact prefix recursion seeded
    # with the converged interior value)
    def var_step_pre(Vk, xs):
        P_f_k, P_p_k1, B_k = xs
        Vn = _sym(P_f_k + quadform(B_k, Vk - P_p_k1))
        return Vn, Vn

    _, V_head_rev = jax.lax.scan(
        var_step_pre, V_interior,
        (P_f_km1[::-1], P_p_pre[::-1], B_pre[::-1]))
    n_interior = n_steps - n_warm - n_term
    if var_mode == "diag":
        # only the OUTPUT is reduced; the transient recursions above are
        # full-covariance (a diagonal-only recursion would be wrong)
        diag = lambda a: jnp.diagonal(a, axis1=-2, axis2=-1)  # noqa: E731
        return mean_out, jnp.concatenate([
            diag(V_head_rev)[::-1],
            jnp.broadcast_to(diag(V_interior), (n_interior, nb, n)),
            diag(V_term_rev)[::-1],
            diag(P_f_st)[None],
        ], axis=0)
    var_out = jnp.concatenate([
        V_head_rev[::-1],
        jnp.broadcast_to(V_interior, (n_interior, nb, n, n)),
        V_term_rev[::-1],
        P_f_st[None],
    ], axis=0)
    return mean_out, var_out


def _extract_affine(wrapped, ode_fun, W_s, x0_s, t1, t_max, validate,
                    params):
    """One-shot affine extraction of the measurement map
    ``h(m) = H_inn m + b`` (exact for affine RHSs; ``h`` is then globally
    affine so the linearization point is irrelevant), plus the
    gain/covariance measurement matrix ``H`` and the variance map
    ``v_fun`` — shared by :func:`solve_mv_stationary` and
    :func:`fenrir_stationary`."""
    nb, n_bmeas, n = W_s.shape
    dtype = x0_s.dtype

    def h_fun(m):
        wgt_m, mean_m, _ = wrapped(
            key=None, ode_fun=ode_fun, ode_weight=W_s, t=t1,
            mean_state_pred=m,
            var_state_pred=jnp.zeros((nb, n, n), dtype=dtype), **params)
        return mvdot(W_s + wgt_m, m) + mean_m

    jac = jax.jacfwd(h_fun)(x0_s)      # (nb, n_bmeas, nb, n)
    H_inn = jnp.moveaxis(jnp.diagonal(jac, axis1=0, axis2=2), -1, 0)
    b = h_fun(x0_s) - mvdot(H_inn, x0_s)
    # the gain/covariance measurement matrix is W + wgt_meas exactly as
    # the sequential filter sees it (for EK0 the Jacobian enters through
    # mean_meas only, so H here is W while the innovation map is W - F);
    # var_meas may depend on the predicted variance (rodeo: W Σ W'), so it
    # re-evaluates inside the Riccati warm-up
    wgt_m0, _, _ = wrapped(
        key=None, ode_fun=ode_fun, ode_weight=W_s, t=t1,
        mean_state_pred=x0_s,
        var_state_pred=jnp.zeros((nb, n, n), dtype=dtype), **params)
    H = W_s + wgt_m0

    if validate:
        # validity probe (two extra interrogations at trace time): the
        # extracted affine map must reproduce the real measurement at a
        # SECOND state and the FINAL grid time; a nonlinear or
        # time-varying ode_fun fails one of these, which otherwise
        # silently returns a wrong posterior (the contract above is only
        # documentation).  Runs as an async debug callback so it costs
        # nothing on the device critical path.
        # relative perturbation: the scaled coordinates span ~1e4 dynamic
        # range, so an absolute offset is invisible on the big entries
        m_probe = x0_s + 0.1 * (1.0 + jnp.abs(x0_s))

        def _h_at(t, m):
            wgt_p, mean_p, _ = wrapped(
                key=None, ode_fun=ode_fun, ode_weight=W_s, t=t,
                mean_state_pred=m,
                var_state_pred=jnp.zeros((nb, n, n), dtype=dtype),
                **params)
            return mvdot(W_s + wgt_p, m) + mean_p

        pred = mvdot(H_inn, m_probe) + b
        h_probe = _h_at(t1, m_probe)
        resid = jnp.maximum(
            jnp.max(jnp.abs(h_probe - pred)),                # nonlinearity
            jnp.max(jnp.abs(_h_at(t_max, x0_s)               # time-variance
                            - (mvdot(H_inn, x0_s) + b))))
        scale = jnp.maximum(jnp.maximum(
            jnp.max(jnp.abs(h_probe)), jnp.max(jnp.abs(pred))), 1e-30)
        # Two-part threshold.  1e-2 * scale: measured margins are ~1e-14
        # (affine, f64) vs ~1.4 relative for a cubic RHS at this probe
        # offset.  PLUS the forward-error bound of the affine evaluation
        # itself, eps * max-rowsum(|H_inn| |m_probe|) — on an affine RHS
        # the residual IS that bound (measured 1.1x at d=128/256/512 on
        # the heat model), and it exceeds 1e-2 * scale once the
        # cancellation in h grows with the state dimension (d=512
        # measured rel 0.071: a fixed relative threshold false-poisoned
        # every large-d solve).  64x margin over the measured floor.
        # Caveat (documented): when eps * rowsum approaches the output
        # scale the probe loses power against WEAK nonlinearities —
        # inherent to f32, not to the probe.
        eps_f = jnp.asarray(jnp.finfo(dtype).eps, dtype)
        rowsum = jnp.max(
            jnp.sum(jnp.abs(H_inn) * jnp.abs(m_probe)[:, None, :],
                    axis=-1) + jnp.abs(b))
        badness = resid / jnp.maximum(
            1e-2 * scale, 64.0 * eps_f * rowsum)
        bad = badness > 1.0
        if isinstance(badness, jax.core.Tracer):
            # async host warning under jit; the DEVICE-SIDE guard below
            # (NaN-poisoned outputs) is what makes a contract violation
            # loud whatever happens to the host message
            jax.debug.callback(_warn_nonaffine, badness)
        else:
            _warn_nonaffine(float(badness))
    else:
        bad = None

    def v_fun(P_p):
        _, _, V = wrapped(
            key=None, ode_fun=ode_fun, ode_weight=W_s, t=t1,
            mean_state_pred=x0_s, var_state_pred=P_p, **params)
        return V.astype(dtype)

    def poison(tree, also_if=None):
        """NaN-poison floating outputs when the affine contract failed
        (in-graph ``where`` gate — no host callback, works under jit on
        every backend).  ``also_if`` ORs in an extra device-side
        failure condition (e.g. the daltonng zero-measurement-noise
        contract)."""
        cond = bad
        if also_if is not None:
            cond = also_if if cond is None else jnp.logical_or(
                cond, also_if)
        if cond is None or cond is False:
            return tree
        return jax.tree_util.tree_map(
            lambda a: jnp.where(cond, jnp.asarray(jnp.nan, a.dtype), a)
            if (hasattr(a, "dtype")
                and jnp.issubdtype(a.dtype, jnp.floating)) else a,
            tree)

    return H, H_inn, b, v_fun, poison


@full_matmul_precision
def solve_mv_stationary(key, ode_fun, ode_weight, ode_init,
                        t_min, t_max, n_steps,
                        interrogate,
                        prior_pars,
                        n_deriv=None, n_warm=100, var_out="full",
                        validate=True, **params):
    r"""
    Stationary-gain :func:`rodeo_tpu.ops.precond.solve_mv` for affine
    time-invariant ODEs (see the module docstring for the validity
    contract).  Same signature plus:

    Args:
        n_warm (int): exact Riccati steps before gains are frozen (also
            the length of the exact head/terminal covariance transients).
            Falls back to the exact path when ``n_warm >= n_steps``.
        validate (bool): when True (default), probe the one-shot affine
            extraction against the real interrogation at a second state
            and the final grid time, and emit a runtime warning if they
            disagree — the cheap guard against silently wrong posteriors
            from a nonlinear or time-varying ``ode_fun`` (the validity
            contract is otherwise enforced only by documentation).  Two
            extra interrogation evaluations; set False to skip.
        var_out (str): smoothed-covariance output — ``"full"``
            ``(N+1, nb, n, n)``, ``"diag"`` ``(N+1, nb, n)`` (marginal
            variances only) or ``"none"`` (``None``).  The internal
            transient recursions are always full-covariance; this only
            controls what is *materialized*, which is the HBM wall for
            very large states (at d=1024 / state dim 3072 the full
            output alone is ~38 GB — ``"diag"`` makes that regime
            runnable on one chip).

    Returns:
        (tuple): smoothed ``mean (n_steps+1, n_block, n_state)`` and
        the covariance per ``var_out``; at the default ``"full"`` this
        matches :func:`rodeo_tpu.solve.solve_mv`.
    """
    if var_out not in ("full", "diag", "none"):
        raise ValueError(
            f"var_out must be 'full', 'diag' or 'none', got {var_out!r}")
    if key is not None:
        raise ValueError(
            "solve_mv_stationary requires a deterministic interrogation "
            "(key=None): the gain freeze assumes the measurement map is "
            "a fixed affine function of the state, which a stochastic "
            "interrogation (e.g. chkrebtii) violates")
    if n_warm >= n_steps:
        from rodeo_tpu.ops import precond
        mean_e, var_e = precond.solve_mv(
            key=key, ode_fun=ode_fun, ode_weight=ode_weight,
            ode_init=ode_init, t_min=t_min, t_max=t_max, n_steps=n_steps,
            interrogate=interrogate, prior_pars=prior_pars,
            n_deriv=n_deriv, **params)
        if var_out == "none":
            return mean_e, None
        if var_out == "diag":
            return mean_e, jnp.diagonal(var_e, axis1=-2, axis2=-1)
        return mean_e, var_e

    t_vec, W_s, x0_s, (Q, R) = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps, n_deriv)
    wrapped = _wrap_interrogate(interrogate, ode_weight, t_vec)
    dtype = x0_s.dtype
    t1 = t_min + (t_max - t_min) / n_steps

    H, H_inn, b, v_fun, poison = _extract_affine(
        wrapped, ode_fun, W_s, x0_s, t1, t_max, validate, params)

    with fast_linalg():
        mean_s, var_s = _stationary_core(
            Q, R, H.astype(dtype), H_inn.astype(dtype), b.astype(dtype),
            v_fun, x0_s, n_steps, n_warm, var_mode=var_out)
    t_v = t_vec.astype(dtype)
    if var_out == "none":
        return poison((mean_s * t_v, None))
    if var_out == "diag":
        return poison((mean_s * t_v, var_s * (t_v * t_v)))
    return poison((mean_s * t_v, var_s * (t_v[:, None] * t_v[None, :])))


# --- stationary fenrir likelihood -------------------------------------------


def _mvn_logpdf_chol(resid, S):
    """Summed Gaussian log-density of the (batched) residuals ``resid``
    ``(nb, k)`` under covariances ``S (nb, k, k)`` (PD), via one Cholesky
    — returns the scalar sum over blocks plus the factor for reuse."""
    import jax.scipy.linalg as jsp_linalg
    chol = jnp.linalg.cholesky(S)
    alpha = jsp_linalg.solve_triangular(
        chol, resid[..., None], lower=True)[..., 0]
    logdet = 2.0 * jnp.sum(jnp.log(
        jnp.diagonal(chol, axis1=-2, axis2=-1)))
    log2pi = jnp.asarray(1.8378770664093453, resid.dtype)
    logp = -0.5 * (jnp.sum(alpha * alpha) + logdet
                   + resid.size * log2pi)
    return logp, chol


@full_matmul_precision
def _fenrir_stationary_core(Q, R, H, H_inn, b_m, v_fun, x0_s,
                            n_steps, n_warm, obs_ind,
                            obs_data, obs_weight_s, obs_var):
    """Scaled-coordinate stationary fenrir backward pass.

    Exact up to the same gain-freeze tolerance as
    :func:`_stationary_core` (:math:`\\rho^{n_{\\text{warm}}}`): the
    backward-chain parameters :math:`(A_k, C_k)` are frozen for rows
    ``k >= n_warm`` and exact on the warm prefix, the backward-filter
    covariance is propagated across inter-observation gaps by operator
    doubling of the frozen map :math:`\\Phi(P) = A P A' + C` (exact — no
    additional periodicity assumption), and the means run as matvec
    scans.  ``obs_ind`` is a static, strictly increasing tuple of grid
    rows.  The pass stops at the earliest observation row — rows below
    it cannot contribute to the likelihood.
    """
    nb, n = x0_s.shape
    f = _stationary_filter(Q, R, H, H_inn, b_m, v_fun, x0_s, n_steps,
                           n_warm)
    B_pre, B_st = f["B_pre"], f["B_st"]
    m_f_all, m_p_all = f["m_f_all"], f["m_p_all"]
    # backward-kernel covariances C_k = P_f[k] - A_k P_p[k+1] A_k'
    # (C_0 = 0 exactly: the init is exact)
    C_pre = _sym(f["P_f_km1"] - quadform(B_pre, f["P_p_pre"]))
    C_st = _sym(f["P_f_st"] - quadform(B_st, f["P_p_st"]))
    # backward-kernel offsets b_k = m_f[k] - A_k m_p[k+1] for k = 0..N-1
    b_head = m_f_all[:n_warm] - mvdot(B_pre, m_p_all[:n_warm])
    b_tail = m_f_all[n_warm:n_steps] - mvdot(B_st, m_p_all[n_warm:])
    b_all = jnp.concatenate([b_head, b_tail], axis=0)

    rows = [int(r) for r in obs_ind]
    n_obs = len(rows)

    # doubling powers of the frozen backward map Phi(P) = A P A' + C:
    # Phi^(2^(i+1)) has A' = A A, C' = A C A' + C; applying the binary
    # digits of a gap g composes Phi^g exactly in O(log g) matmuls
    gaps = []
    prev = n_steps
    for r in reversed(rows):
        if prev - max(r, n_warm) > 0:
            gaps.append(prev - max(r, n_warm))
        prev = r
    max_gap = max(gaps) if gaps else 0
    A_pows, C_pows = [B_st], [C_st]
    for _ in range(max(max_gap.bit_length() - 1, 0)):
        Ai, Ci = A_pows[-1], C_pows[-1]
        A_pows.append(Ai @ Ai)
        C_pows.append(_sym(quadform(Ai, Ci) + Ci))

    def cov_prop(P, lo, hi):
        """Propagate the backward-filter covariance from row ``hi`` down
        to row ``lo`` (applying kernels ``k = hi-1 .. lo``)."""
        mid = min(max(lo, n_warm), hi)
        g = hi - mid
        i = 0
        while g:                      # frozen region: operator doubling
            if g & 1:
                P = _sym(quadform(A_pows[i], P) + C_pows[i])
            g >>= 1
            i += 1
        if mid > lo:                  # warm prefix: exact per-step kernels
            P, _ = jax.lax.scan(
                lambda PP, x: (_sym(quadform(x[0], PP) + x[1]), None),
                P, (B_pre[lo:mid][::-1], C_pre[lo:mid][::-1]))
        return P

    def mean_prop(m, lo, hi):
        """Propagate the backward-filter mean from row ``hi`` down to
        row ``lo`` (time-varying offsets — per-step matvec scans)."""
        mid = min(max(lo, n_warm), hi)
        if hi > mid:                  # frozen gain, varying offset
            m, _ = _uscan(
                lambda mm, bk: (mvdot(B_st, mm) + bk, None),
                m, b_all[mid:hi][::-1])
        if mid > lo:                  # warm prefix
            m, _ = jax.lax.scan(
                lambda mm, x: (mvdot(x[0], mm) + x[1], None),
                m, (B_pre[lo:mid][::-1], b_all[lo:mid][::-1]))
        return m

    eye = jnp.broadcast_to(jnp.eye(n, dtype=x0_s.dtype), (nb, n, n))

    def obs_update(m, P, j):
        """Forecast log-density + Kalman update at observation ``j``."""
        D, y, Om = obs_weight_s[j], obs_data[j], obs_var[j]
        resid = y - mvdot(D, m)
        S = _sym(quadform(D, P) + Om)
        logp, chol = _mvn_logpdf_chol(resid, S)
        import jax.scipy.linalg as jsp_linalg
        DP = D @ P
        X = jsp_linalg.solve_triangular(
            chol, jsp_linalg.solve_triangular(chol, DP, lower=True),
            lower=True, trans=1)
        K = mtt(X)                    # (nb, n, n_bobs)
        m_new = m + mvdot(K, resid)
        IKD = eye - K @ D
        P_new = _sym(quadform(IKD, P) + quadform(K, Om))
        return m_new, P_new, logp

    # backward pass, observation to observation
    cur = n_steps
    m = m_f_all[n_steps]
    P = f["P_f_st"]                   # P_f[N] (frozen tail)
    logdens = jnp.zeros((), dtype=x0_s.dtype)
    for j in range(n_obs - 1, -1, -1):
        r = rows[j]
        if r < cur:
            m = mean_prop(m, r, cur)
            P = cov_prop(P, r, cur)
            cur = r
        m, P, logp = obs_update(m, P, j)
        logdens = logdens + logp
    return logdens


@full_matmul_precision
def fenrir_stationary(key, ode_fun, ode_weight, ode_init,
                      t_min, t_max, n_steps,
                      interrogate,
                      prior_pars,
                      obs_data, obs_times, obs_weight, obs_var,
                      n_deriv=None, n_warm=32, validate=True, **params):
    r"""
    Stationary-gain :func:`rodeo_tpu.ops.precond.fenrir` for affine
    time-invariant ODEs — Bayesian parameter inference in the
    large-state regime (module docstring has the validity contract and
    the complexity argument).  Functional parity target:
    ``/root/reference/src/rodeo/inference/fenrir.py:261-328``
    (``fenrir``), restricted to affine RHSs; matches
    :func:`rodeo_tpu.ops.precond.fenrir` up to the gain-freeze
    tolerance :math:`O(\rho^{n_{\text{warm}}})`.

    Same signature as :func:`rodeo_tpu.ops.precond.fenrir` plus
    ``n_warm`` / ``validate`` (as in :func:`solve_mv_stationary`), with
    one restriction: ``obs_times`` (and the grid spec) must be
    *concrete* — the inter-observation gap structure is compiled into
    the program, so close over observation times instead of passing
    them as traced jit arguments.  ``obs_data`` / ``obs_weight`` /
    ``obs_var`` and any ``params`` may be traced as usual (the common
    parameter-inference case: fixed design, :math:`\theta` traced).
    Fully differentiable (the frozen-gain approximation is itself a
    smooth function of the inputs).

    ACCURACY MODEL — choose ``n_warm`` for the likelihood, not the
    solve: the freeze error of the *value* scales like
    :math:`(N - n_{\text{warm}})\,\rho^{n_{\text{warm}}}` with
    :math:`\rho` the slowest Riccati convergence rate, and the
    *gradient* amplifies it.  On strongly observed / dissipative
    configurations :math:`\rho` is small and ``n_warm`` of a few tens
    reaches float precision (measured 1e-9 relative at ``n_warm=5`` on
    the mild heat fixture).  On weakly observed stiff configurations
    with diffuse priors the filter covariance has slow modes
    (:math:`\rho \approx 0.96` measured on the d=32 heat benchmark
    config — value 3e-4 relative at ``n_warm=32`` but gradient O(1)
    there; see ``docs/design.md``).  The dial goes all the way to
    EXACT: at ``n_warm >= n_steps`` the warm prefix covers every row
    and the result equals :func:`rodeo_tpu.ops.precond.fenrir` to
    machine precision (measured 4e-16/5e-14 value/grad) — still
    several-fold faster, since the interrogation is hoisted out of the
    covariance scan and the backward pass touches only observation
    rows.

    Returns:
        (float): the fenrir log-likelihood
        :math:`\log p(Y_{0:M} \mid Z_{1:N})`.
    """
    if key is not None:
        raise ValueError(
            "fenrir_stationary requires a deterministic interrogation "
            "(key=None): the gain freeze assumes the measurement map is "
            "a fixed affine function of the state, which a stochastic "
            "interrogation (e.g. chkrebtii) violates")
    try:
        obs_times_np = np.asarray(obs_times)
        grid = np.linspace(float(t_min), float(t_max), int(n_steps) + 1)
    except (jax.errors.TracerArrayConversionError,
            jax.errors.ConcretizationTypeError) as e:
        raise ValueError(
            "fenrir_stationary requires concrete (non-traced) obs_times "
            "and grid bounds: the gap structure between observations is "
            "compiled into the program.  Close over them instead of "
            "passing them as jit arguments (obs_data/obs_weight/obs_var "
            "and model params may be traced as usual).") from e
    obs_ind = tuple(int(i) for i in np.searchsorted(grid, obs_times_np))
    if any(b <= a for a, b in zip(obs_ind, obs_ind[1:])):
        raise ValueError(
            "fenrir_stationary requires strictly increasing observation "
            f"times mapping to distinct grid rows; got rows {obs_ind}")
    if obs_ind and (obs_ind[0] < 0 or obs_ind[-1] > n_steps):
        raise ValueError(
            f"observation rows {obs_ind} fall outside the solution grid "
            f"[0, {n_steps}]")
    # n_warm >= n_steps: the warm prefix covers every row, the frozen
    # region is empty, and the core computes the EXACT fenrir likelihood
    # (still several-fold faster than precond.fenrir — the interrogation
    # is hoisted out of the Riccati scan and the backward pass skips the
    # between-observation updates)
    n_warm = min(int(n_warm), int(n_steps))

    t_vec, W_s, x0_s, (Q, R) = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps, n_deriv)
    wrapped = _wrap_interrogate(interrogate, ode_weight, t_vec)
    dtype = x0_s.dtype
    t1 = t_min + (t_max - t_min) / n_steps
    obs_weight_s = obs_weight * t_vec.astype(obs_weight.dtype)

    H, H_inn, b, v_fun, poison = _extract_affine(
        wrapped, ode_fun, W_s, x0_s, t1, t_max, validate, params)

    with fast_linalg():
        return poison(_fenrir_stationary_core(
            Q, R, H.astype(dtype), H_inn.astype(dtype), b.astype(dtype),
            v_fun, x0_s, n_steps, n_warm, obs_ind,
            obs_data.astype(dtype), obs_weight_s.astype(dtype),
            obs_var.astype(dtype)))


@full_matmul_precision
def _dalton_stationary_core(Q, R, H, H_inn, b_m, v_fun, x0_s, n_steps,
                            n_warm, obs_ind, obs_data, obs_weight_s,
                            obs_var):
    r"""Scaled-coordinate hoisted-affine DALTON log-likelihood
    :math:`\log p(Y \mid Z) = \log p(Z, Y) - \log p(Z)`.

    Two forward filters with the interrogation hoisted to the one-shot
    affine map (the dominant per-step cost at large state dims — a
    jacfwd of the RHS — leaves the time loop entirely):

    - the JOINT :math:`p(Z, Y)` filter runs exact per-segment
      ``lax.scan``\ s between the static observation rows, with the
      reference's stacked (ODE + observation) forecast density at each
      observation row followed by the sequential ODE-then-data state
      updates (float32-robust, `rodeo_tpu/inference/dalton.py`
      docstring);
    - the MARGINAL :math:`p(Z)` filter has no data updates, so it IS
      the stationary solver filter: covariances from the ``n_warm``
      Riccati warm-up (frozen after), forecast residuals from the
      matvec-only mean predictions, and the density assembled fully
      batched (one Cholesky per warm row + ONE frozen Cholesky whose
      log-determinant multiplies the tail count).

    Density factors use plain Cholesky log-densities: the stationary
    contract (affine RHS, deterministic interrogation, PD prior noise)
    keeps every forecast covariance PD, so upstream's degenerate-
    direction eigen masking never activates.  Functional parity target:
    ``/root/reference/src/rodeo/inference/dalton.py:39-235``.
    """
    nb, n = x0_s.shape
    dtype = x0_s.dtype
    eye = jnp.broadcast_to(jnp.eye(n, dtype=dtype), (nb, n, n))
    P_zero = jnp.zeros((nb, n, n), dtype=dtype)
    V0 = v_fun(P_zero)
    v_lin = lambda P: jax.jvp(v_fun, (P_zero,), (P,))[1]  # noqa: E731
    log2pi = jnp.asarray(1.8378770664093453, dtype)

    def predict(m, P):
        m_p = mvdot(Q, m)
        P_p = _sym(quadform(Q, P) + R)
        V = V0 + v_lin(P_p)
        fore = mvdot(H_inn, m_p) + b_m            # ODE forecast mean
        S = _sym(quadform(H, P_p) + V)
        return m_p, P_p, V, fore, S

    def ode_update(m_p, P_p, V, fore, S):
        K = mtt(solve_psd(S, H @ P_p))
        m_f = m_p - mvdot(K, fore)
        ikw = eye - K @ H
        P_f = _sym(quadform(ikw, P_p) + quadform(K, V))
        return m_f, P_f

    def plain_step(carry, _):
        m, P, ld = carry
        m_p, P_p, V, fore, S = predict(m, P)
        logp, _ = _mvn_logpdf_chol(-fore, S)
        m_f, P_f = ode_update(m_p, P_p, V, fore, S)
        return (m_f, P_f, ld + logp), None

    def run_plain(state, length):
        if length <= 0:
            return state
        out, _ = jax.lax.scan(plain_step, state, None, length=length)
        return out

    def obs_step(state, j):
        """Stacked forecast density + ODE update + data update at
        observation row ``j`` (one grid step)."""
        m, P, ld = state
        D, y, Om = obs_weight_s[j], obs_data[j], obs_var[j]
        m_p, P_p, V, fore, S = predict(m, P)
        # stacked (ODE + observation) forecast of [x_meas=0; y]
        PD = P_p @ mtt(D)                          # (nb, n, n_bobs)
        S_xo = H @ PD                              # (nb, k, n_bobs)
        S_oo = _sym(D @ PD + Om)
        S_top = jnp.concatenate([S, S_xo], axis=-1)
        S_bot = jnp.concatenate([mtt(S_xo), S_oo], axis=-1)
        S_stack = jnp.concatenate([S_top, S_bot], axis=-2)
        resid = jnp.concatenate([-fore, y - mvdot(D, m_p)], axis=-1)
        logp, _ = _mvn_logpdf_chol(resid, S_stack)
        # sequential state updates: ODE pseudo-observation, then data
        m_f, P_f = ode_update(m_p, P_p, V, fore, S)
        resid_u = y - mvdot(D, m_f)
        S_u = _sym(quadform(D, P_f) + Om)
        K_o = mtt(solve_psd(S_u, D @ P_f))
        m_o = m_f + mvdot(K_o, resid_u)
        iko = eye - K_o @ D
        P_o = _sym(quadform(iko, P_f) + quadform(K_o, Om))
        return (m_o, P_o, ld + logp)

    # --- joint filter p(Z, Y): exact per-segment scans ---------------
    rows = [int(r) for r in obs_ind]
    ld0 = jnp.zeros((), dtype)
    if rows and rows[0] == 0:
        D0, y0, Om0 = obs_weight_s[0], obs_data[0], obs_var[0]
        ld0, _ = _mvn_logpdf_chol(y0 - mvdot(D0, x0_s), Om0)
        rows = rows[1:]
        obs_off = 1
    else:
        obs_off = 0
    state = (x0_s, P_zero, jnp.zeros((), dtype))
    cur = 0
    for j, r in enumerate(rows):
        state = run_plain(state, r - cur - 1)
        state = obs_step(state, j + obs_off)
        cur = r
    state = run_plain(state, n_steps - cur)
    ld_joint = state[2]

    # --- marginal filter p(Z): frozen-gain, fully batched density ----
    f = _stationary_filter(Q, R, H, H_inn, b_m, v_fun, x0_s, n_steps,
                           n_warm)
    fore_all = (jnp.einsum("bij,tbj->tbi", H_inn, f["m_p_all"])
                + b_m)                               # (N, nb, k)
    k_meas = fore_all.shape[-1]
    import jax.scipy.linalg as jsp_linalg
    # warm prefix: per-row Cholesky densities, batched over rows
    P_p_pre = f["P_p_pre"]                           # (n_warm, nb, n, n)
    V_pre = V0 + jax.vmap(v_lin)(P_p_pre)
    S_pre = _sym(jnp.einsum("bik,tbkl,bjl->tbij", H, P_p_pre, H)
                 + V_pre)
    chol_pre = jnp.linalg.cholesky(S_pre)
    a_pre = jsp_linalg.solve_triangular(
        chol_pre, -fore_all[:n_warm][..., None], lower=True)[..., 0]
    logdet_pre = 2.0 * jnp.sum(jnp.log(jnp.diagonal(
        chol_pre, axis1=-2, axis2=-1)))
    # frozen tail: one Cholesky; the log-determinant multiplies the count
    n_tail = n_steps - n_warm
    S_st = _sym(quadform(H, f["P_p_st"]) + (V0 + v_lin(f["P_p_st"])))
    chol_st = jnp.linalg.cholesky(S_st)
    a_tail = jsp_linalg.solve_triangular(
        jnp.broadcast_to(chol_st, (n_tail,) + chol_st.shape),
        -fore_all[n_warm:][..., None], lower=True)[..., 0]
    logdet_st = 2.0 * jnp.sum(jnp.log(jnp.diagonal(
        chol_st, axis1=-2, axis2=-1)))
    ld_marg = -0.5 * (
        jnp.sum(a_pre * a_pre) + jnp.sum(a_tail * a_tail)
        + logdet_pre + n_tail * logdet_st
        + n_steps * nb * k_meas * log2pi)

    return ld0 + ld_joint - ld_marg


@full_matmul_precision
def dalton_stationary(key, ode_fun, ode_weight, ode_init,
                      t_min, t_max, n_steps,
                      interrogate,
                      prior_pars,
                      obs_data, obs_times, obs_weight, obs_var,
                      n_deriv=None, n_warm=32, validate=True, **params):
    r"""
    Hoisted-affine :func:`rodeo_tpu.ops.precond.dalton` for affine
    time-invariant ODEs — the DALTON data likelihood in the large-state
    regime (module docstring has the validity contract).  Functional
    parity target: ``/root/reference/src/rodeo/inference/dalton.py``
    (``dalton``), restricted to affine RHSs with PD forecast
    covariances.

    Same signature/restrictions as :func:`fenrir_stationary`
    (``obs_times`` and the grid must be concrete; ``key`` must be
    ``None``); fully differentiable.

    ACCURACY MODEL: the JOINT :math:`p(Z, Y)` filter is exact (its
    covariances are carried through per-segment scans — data updates
    perturb the Riccati state, so its gains are not frozen); only the
    MARGINAL :math:`p(Z)` filter freezes after ``n_warm`` Riccati
    steps, and its value error follows the
    :func:`fenrir_stationary` accuracy model
    (:math:`(N - n_{\text{warm}})\,\rho^{n_{\text{warm}}}`); at
    ``n_warm >= n_steps`` the result is exact up to fp.  The hoisted
    interrogation (no per-step ``jacfwd``) is what buys the large-state
    speedup in BOTH passes.

    Returns:
        (float): the DALTON log-likelihood
        :math:`\log p(Y_{0:M} \mid Z_{1:N})`.
    """
    if key is not None:
        raise ValueError(
            "dalton_stationary requires a deterministic interrogation "
            "(key=None): the hoisted affine measurement map assumes a "
            "fixed measurement model, which a stochastic interrogation "
            "(e.g. chkrebtii) violates")
    try:
        obs_times_np = np.asarray(obs_times)
        grid = np.linspace(float(t_min), float(t_max), int(n_steps) + 1)
    except (jax.errors.TracerArrayConversionError,
            jax.errors.ConcretizationTypeError) as e:
        raise ValueError(
            "dalton_stationary requires concrete (non-traced) obs_times "
            "and grid bounds: the segment structure between observations "
            "is compiled into the program.  Close over them instead of "
            "passing them as jit arguments (obs_data/obs_weight/obs_var "
            "and model params may be traced as usual).") from e
    obs_ind = tuple(int(i) for i in np.searchsorted(grid, obs_times_np))
    if any(b <= a for a, b in zip(obs_ind, obs_ind[1:])):
        raise ValueError(
            "dalton_stationary requires strictly increasing observation "
            f"times mapping to distinct grid rows; got rows {obs_ind}")
    if obs_ind and (obs_ind[0] < 0 or obs_ind[-1] > n_steps):
        raise ValueError(
            f"observation rows {obs_ind} fall outside the solution grid "
            f"[0, {n_steps}]")
    n_warm = min(int(n_warm), int(n_steps))

    t_vec, W_s, x0_s, (Q, R) = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps, n_deriv)
    wrapped = _wrap_interrogate(interrogate, ode_weight, t_vec)
    dtype = x0_s.dtype
    t1 = t_min + (t_max - t_min) / n_steps
    obs_weight_s = obs_weight * t_vec.astype(obs_weight.dtype)

    H, H_inn, b, v_fun, poison = _extract_affine(
        wrapped, ode_fun, W_s, x0_s, t1, t_max, validate, params)

    # blocked (n_obs, nb, n_bobs[, ...]) observation arrays collapse to
    # the dense single-block layout the core uses
    obs_w = obs_weight_s.reshape(
        obs_weight_s.shape[0], obs_weight_s.shape[1],
        obs_weight_s.shape[2], -1)

    # frozen joint pass (two-transient trick) needs identical per-row
    # observation models; verify at trace time when the design arrays
    # are concrete, and fall back to the exact per-segment scans when
    # they differ or cannot be checked.  NB: test the RAW user arrays —
    # inside jit every jnp operation yields a tracer even on concrete
    # operands, so the scaled obs_weight_s is never inspectable, while
    # the untouched kwargs stay concrete closure constants in the
    # common close-over-the-design pattern
    frozen_ok = False
    if n_warm < n_steps:
        try:
            W_np = np.asarray(obs_weight)
            V_np = np.asarray(obs_var)
            frozen_ok = bool(np.all(W_np == W_np[:1])
                             and np.all(V_np == V_np[:1]))
        except (jax.errors.TracerArrayConversionError,
                jax.errors.ConcretizationTypeError):
            frozen_ok = False

    core = (_dalton_stationary_frozen_core if frozen_ok
            else _dalton_stationary_core)
    with fast_linalg():
        return poison(core(
            Q, R, H.astype(dtype), H_inn.astype(dtype), b.astype(dtype),
            v_fun, x0_s, n_steps, n_warm, obs_ind,
            obs_data.astype(dtype), obs_w.astype(dtype),
            obs_var.astype(dtype)))


@full_matmul_precision
def _dalton_stationary_frozen_core(Q, R, H, H_inn, b_m, v_fun, x0_s,
                                   n_steps, n_warm, obs_ind, obs_data,
                                   obs_weight_s, obs_var):
    r"""Frozen-gain joint pass for :func:`dalton_stationary` — the
    two-transient trick.

    With identical per-row observation models, every inter-observation
    segment of the joint :math:`p(Z, Y)` filter re-converges to the SAME
    no-data Riccati fixed point, and the post-update covariance at a
    converged observation row is one shared value — so the whole joint
    covariance path is TWO warm transients (A: from the Dirac init;
    B: from the shared post-update covariance), reused across segments
    as prefix tables.  Covariance work drops from :math:`O(N)` to
    :math:`O(2\,n_{\text{warm}} + M)` rows; the means and forecast
    residuals run as per-segment matvec scans against gathered gains,
    and the density assembles from batched Cholesky solves plus
    prefix-summed log-determinants.  Freeze error follows the
    :func:`fenrir_stationary` accuracy model with the per-segment gap
    lengths in place of the tail length.  The marginal pass is the same
    batched assembly as :func:`_dalton_stationary_core`.
    """
    nb, n = x0_s.shape
    dtype = x0_s.dtype
    import jax.scipy.linalg as jsp_linalg
    eye = jnp.broadcast_to(jnp.eye(n, dtype=dtype), (nb, n, n))
    P_zero = jnp.zeros((nb, n, n), dtype=dtype)
    V0 = v_fun(P_zero)
    v_lin = lambda P: jax.jvp(v_fun, (P_zero,), (P,))[1]  # noqa: E731
    log2pi = jnp.asarray(1.8378770664093453, dtype)
    k_meas = H.shape[1]

    def ric_step(P_f, _):
        P_p = _sym(quadform(Q, P_f) + R)
        V = V0 + v_lin(P_p)
        S = _sym(quadform(H, P_p) + V)
        K = mtt(solve_psd(S, H @ P_p))
        ikw = eye - K @ H
        P_f_new = _sym(quadform(ikw, P_p) + quadform(K, V))
        return P_f_new, (P_p, P_f_new, K, S)

    def warm(P0):
        """Transient tables from filtered covariance ``P0``: offsets
        ``t = 1..n_warm`` plus cumulative log-determinants."""
        _, (P_p, P_f, K, S) = jax.lax.scan(
            ric_step, P0, None, length=n_warm)
        chol = jnp.linalg.cholesky(S)
        logdets = 2.0 * jnp.sum(jnp.log(jnp.diagonal(
            chol, axis1=-2, axis2=-1)), axis=(-1,))   # (n_warm, nb)
        ld_row = jnp.sum(logdets, axis=-1)            # (n_warm,)
        ld_cum = jnp.concatenate([jnp.zeros((1,), dtype),
                                  jnp.cumsum(ld_row)])
        return dict(P_p=P_p, P_f=P_f, K=K, chol=chol, ld_cum=ld_cum,
                    P_p_st=P_p[-1], P_f_st=P_f[-1], K_st=K[-1],
                    chol_st=chol[-1], ld_st=ld_row[-1])

    # shared observation model (identical rows — enforced by the caller)
    D0 = obs_weight_s[0]
    Om0 = obs_var[0]

    def data_update_cov(P_f):
        S_u = _sym(quadform(D0, P_f) + Om0)
        K_o = mtt(solve_psd(S_u, D0 @ P_f))
        iko = eye - K_o @ D0
        return _sym(quadform(iko, P_f) + quadform(K_o, Om0)), K_o

    trans_A = warm(P_zero)
    P_post_st, _ = data_update_cov(trans_A["P_f_st"])
    trans_B = warm(P_post_st)

    def gather(tab, L):
        """Prefix of a per-offset transient table padded with its frozen
        value to length ``L`` (static)."""
        head = tab[: min(L, n_warm)]
        if L > n_warm:
            pad = jnp.broadcast_to(tab[-1], (L - n_warm,) + tab.shape[1:])
            head = jnp.concatenate([head, pad])
        return head

    def mean_scan(m0, K_seq):
        """Joint-pass means over one segment: predictions and forecast
        residual means per step (matvec only)."""
        def step(m, K_t):
            m_p = mvdot(Q, m)
            fore = mvdot(H_inn, m_p) + b_m
            m_f = m_p - mvdot(K_t, fore)
            return m_f, (m_p, fore)
        return jax.lax.scan(step, m0, K_seq)

    def seg_density(T, fore, n_plain):
        """Plain ODE forecast terms for the first ``n_plain`` rows of a
        segment (batched Cholesky solves + prefix-summed logdets)."""
        if n_plain <= 0:
            return jnp.zeros((), dtype)
        n_head = min(n_plain, n_warm)
        chols = gather(T["chol"], n_plain)
        a = jsp_linalg.solve_triangular(
            chols, -fore[:n_plain][..., None], lower=True)[..., 0]
        logdet = (T["ld_cum"][n_head]
                  + max(0, n_plain - n_warm) * T["ld_st"])
        return -0.5 * (jnp.sum(a * a) + logdet
                       + n_plain * nb * k_meas * log2pi)

    rows = [int(r) for r in obs_ind]
    ld0 = jnp.zeros((), dtype)
    obs_off = 0
    if rows and rows[0] == 0:
        ld0, _ = _mvn_logpdf_chol(
            obs_data[0] - mvdot(obs_weight_s[0], x0_s), obs_var[0])
        rows = rows[1:]
        obs_off = 1

    ld_joint = jnp.zeros((), dtype)
    m = x0_s
    cur = 0
    # segments: (cur, r] for each obs row r, then the trailing (r_M, N]
    for s, r in enumerate(rows + [n_steps]):
        L = r - cur
        T = trans_A if s == 0 else trans_B
        is_obs = s < len(rows)
        if L > 0:
            K_seq = gather(T["K"], L)
            m_f, (m_p_seq, fore_seq) = mean_scan(m, K_seq)
            n_plain = L - 1 if is_obs else L
            ld_joint = ld_joint + seg_density(T, fore_seq, n_plain)
            m = m_f
        if is_obs:
            j = s + obs_off
            idx = min(L, n_warm) - 1
            P_p_r = T["P_p"][idx] if L <= n_warm else T["P_p_st"]
            P_f_r = T["P_f"][idx] if L <= n_warm else T["P_f_st"]
            m_p_r, fore_r = m_p_seq[-1], fore_seq[-1]
            y = obs_data[j]
            # stacked (ODE + observation) forecast term
            V_r = V0 + v_lin(P_p_r)
            S_xx = _sym(quadform(H, P_p_r) + V_r)
            PD = P_p_r @ mtt(D0)
            S_xo = H @ PD
            S_oo = _sym(D0 @ PD + Om0)
            S_stack = jnp.concatenate([
                jnp.concatenate([S_xx, S_xo], axis=-1),
                jnp.concatenate([mtt(S_xo), S_oo], axis=-1)], axis=-2)
            resid = jnp.concatenate(
                [-fore_r, y - mvdot(D0, m_p_r)], axis=-1)
            logp, _ = _mvn_logpdf_chol(resid, S_stack)
            ld_joint = ld_joint + logp
            # data update on the mean with the transient's gain
            _, K_o = data_update_cov(P_f_r)
            m = m + mvdot(K_o, y - mvdot(D0, m))
            cur = r

    # --- marginal p(Z): identical assembly to the exact core ----------
    f = _stationary_filter(Q, R, H, H_inn, b_m, v_fun, x0_s, n_steps,
                           n_warm)
    fore_all = (jnp.einsum("bij,tbj->tbi", H_inn, f["m_p_all"]) + b_m)
    a_pre = jsp_linalg.solve_triangular(
        trans_A["chol"], -fore_all[:n_warm][..., None], lower=True)[..., 0]
    n_tail = n_steps - n_warm
    a_tail = jsp_linalg.solve_triangular(
        jnp.broadcast_to(trans_A["chol_st"],
                         (n_tail,) + trans_A["chol_st"].shape),
        -fore_all[n_warm:][..., None], lower=True)[..., 0]
    ld_marg = -0.5 * (
        jnp.sum(a_pre * a_pre) + jnp.sum(a_tail * a_tail)
        + trans_A["ld_cum"][n_warm] + n_tail * trans_A["ld_st"]
        + n_steps * nb * k_meas * log2pi)

    return ld0 + ld_joint - ld_marg


@full_matmul_precision
def _daltonng_stationary_core(Q, R, H, H_inn, b_m, v_fun, x0_s, n_steps,
                              n_warm, obs_ind, obs_data, obs_ll_s, params):
    r"""Scaled-coordinate hoisted-affine non-Gaussian DALTON:
    :math:`\log p(Y|Z) \approx \log p(Y|\hat x) + \log p(\hat x|Z)
    - \log p(\hat x|\hat Y, Z)` with :math:`\hat x` the smoothed mean of
    the Laplace-linearized data-conditioned filter (Chib's identity over
    the Laplace-Gaussian surrogate — exactly the reference's
    ``daltonng`` decomposition, ``dalton.py:849-949``).

    Large-state formulation (the plain path's per-step ``pinv`` lowers to
    an SVD and its backward log-densities to batched ``eigh``, neither
    of which compiles tractably at state dim 384):

    - the observation Hessian is required to be COORDINATEWISE DIAGONAL
      (independent per-coordinate observation likelihoods — Gaussian,
      Poisson, any GLM with one state coordinate per datum), so the
      Laplace pseudo-observation inverts elementwise, dead coordinates
      (zero Hessian row) becoming exact identity updates;
    - every covariance op is Cholesky-based (PD by the stationary
      validity contract), and both backward passes are assembled fully
      batched: the ``logx_yhat`` residuals vanish identically at the
      smoothed mean (only log-determinants survive), and the ``logx_z``
      residuals are closed-form in the stored moments, so neither pass
      scans covariances.

    Both filters carry exact covariance recursions (``n_warm`` is
    pinned to ``n_steps`` by the wrapper — see its docstring for why
    freezing cannot work here).
    """
    nb, n = x0_s.shape
    dtype = x0_s.dtype
    eye = jnp.broadcast_to(jnp.eye(n, dtype=dtype), (nb, n, n))
    P_zero = jnp.zeros((nb, n, n), dtype=dtype)
    V0 = v_fun(P_zero)
    v_lin = lambda P: jax.jvp(v_fun, (P_zero,), (P,))[1]  # noqa: E731
    obs_row = np.full(n_steps + 1, -1, dtype=np.int64)
    for j, r in enumerate(obs_ind):
        obs_row[r] = j
    obs_row = jnp.asarray(obs_row)

    grad_fn = jax.jacrev(obs_ll_s, argnums=1)
    hess_fn = jax.jacfwd(grad_fn, argnums=1)

    # --- pass 1: exact Laplace-linearized (joint) forward filter -----
    def nn_step(carry, t):
        m_f, P_f = carry
        m_p = mvdot(Q, m_f)
        P_p = _sym(quadform(Q, P_f) + R)
        V = V0 + v_lin(P_p)
        fore = mvdot(H_inn, m_p) + b_m
        S = _sym(quadform(H, P_p) + V)
        K = mtt(solve_psd(S, H @ P_p))
        m_mid = m_p - mvdot(K, fore)
        ikw = eye - K @ H
        P_mid = _sym(quadform(ikw, P_p) + quadform(K, V))

        def data_update():
            j = obs_row[t + 1]
            y_j = obs_data[j]
            g = grad_fn(y_j, m_p, j, **params)          # (nb, n)
            hes = hess_fn(y_j, m_p, j, **params)        # (nb, n, nb, n)
            hd = jnp.moveaxis(
                jnp.diagonal(hes, axis1=0, axis2=2), -1, 0)  # (nb, n, n)
            d_diag = jnp.diagonal(hd, axis1=-2, axis2=-1)    # (nb, n)
            live = d_diag != 0
            # Laplace pseudo-observation variance: -1/Hess on live
            # coordinates, unit variance + zero weight (exact identity
            # update) on dead ones
            var_d = jnp.where(live, -1.0 / jnp.where(live, d_diag, -1.0),
                              1.0)
            livef = live.astype(dtype)
            obs_hat = livef * m_p + var_d * g
            # diagonal-model Kalman update on top of the ODE update
            S_u = P_mid * (livef[..., :, None] * livef[..., None, :]) \
                + jax.vmap(jnp.diag)(var_d)
            K_o = mtt(solve_psd(S_u, livef[..., :, None] * P_mid))
            m_o = m_mid + mvdot(K_o, livef * (obs_hat - m_mid))
            iko = eye - K_o * livef[..., None, :]
            P_o = _sym(quadform(iko, P_mid)
                       + quadform(K_o, jax.vmap(jnp.diag)(var_d)))
            return m_o, P_o

        is_obs = obs_row[t + 1] >= 0
        m_n, P_n = jax.lax.cond(
            is_obs, data_update, lambda: (m_mid, P_mid))
        return (m_n, P_n), (m_p, P_p, m_n, P_n)

    (_, _), (m_p_nn, P_p_nn, m_f_nn, P_f_nn) = jax.lax.scan(
        nn_step, (x0_s, P_zero), jnp.arange(n_steps))

    # --- pass 2: smoothed means + logx_yhat (zero-residual logdets) --
    # smooth_cond gains/covariances at rows k = 1..N-1, batched:
    #   A_k = P_f[k] Q' P_p[k+1]^{-1},  C_k = P_f[k] - A_k P_p[k+1] A_k'
    A_nn = mtt(solve_psd(P_p_nn[1:], Q @ P_f_nn[:-1]))
    C_nn = _sym(P_f_nn[:-1] - jnp.einsum(
        "tbij,tbjk,tblk->tbil", A_nn, P_p_nn[1:], A_nn))

    def mean_step(x_next, xs):
        A_k, m_f_k, m_p_k1 = xs
        x_k = m_f_k + mvdot(A_k, x_next - m_p_k1)
        return x_k, x_k

    _, xs_mid = jax.lax.scan(
        mean_step, m_f_nn[-1], (A_nn, m_f_nn[:-1], m_p_nn[1:]),
        reverse=True)
    x_hat = jnp.concatenate([x0_s[None], xs_mid, m_f_nn[-1][None]])

    # The smoothing covariances are SINGULAR by construction whenever the
    # interrogation carries zero measurement noise (kramer/schober: each
    # update zeroes variance along the H rows exactly — H P_f = 0 since
    # H(I - KH) = 0 when S = H P_p H', and the null space propagates to
    # every smooth_cond C and to P_f[N]).  The null space is therefore
    # STRUCTURAL and time-invariant: span(H').  One complete QR of H'
    # yields the live-space basis, turning every masked-eigh logpdf of
    # the plain path (a batched eigh at state dim 384) into a projected
    # Cholesky, with
    # identical value in exact arithmetic.
    k_meas = H.shape[-2]
    n_live = n - k_meas
    # gradient flows through residuals/covariances, not the basis: the
    # assembled logx_z - logx_yhat is invariant to the choice of live
    # basis (the dropped degenerate directions cancel between the two
    # terms), and complete-mode QR has no JAX derivative anyway —
    # verified against the exact preconditioned path's kappa-gradient by
    # tests/test_daltonng_large_state.py::test_daltonng_stationary_kappa_gradient
    qfull, _ = jnp.linalg.qr(jax.lax.stop_gradient(mtt(H)),
                             mode="complete")
    U_live = qfull[..., k_meas:]                     # (nb, n, n-k)
    import jax.scipy.linalg as jsp_linalg
    log2pi = jnp.asarray(1.8378770664093453, dtype)

    def live_logpdf_sum(resid, C):
        """Summed Gaussian log-density on the structural live subspace.
        ``resid (..., nb, n)``, ``C (..., nb, n, n)``."""
        Cl = _sym(jnp.einsum("bni,...bnm,bmj->...bij", U_live, C, U_live))
        rl = jnp.einsum("bni,...bn->...bi", U_live, resid)
        chol = jnp.linalg.cholesky(Cl)
        a = jsp_linalg.solve_triangular(
            chol, rl[..., None], lower=True)[..., 0]
        ld = 2.0 * jnp.sum(jnp.log(jnp.diagonal(
            chol, axis1=-2, axis2=-1)))
        cnt = rl.size // n_live
        return -0.5 * (jnp.sum(a * a) + ld + cnt * n_live * log2pi)

    logx_yhat = live_logpdf_sum(jnp.zeros_like(m_f_nn[-1]), P_f_nn[-1])
    logx_yhat += live_logpdf_sum(jnp.zeros_like(xs_mid), C_nn)

    # --- pass 3: marginal p(x_hat | Z) over the plain filter ---------
    # (n_warm is pinned to n_steps by the wrapper, so the prefix arrays
    # cover the whole grid and the recursion is exact)
    f = _stationary_filter(Q, R, H, H_inn, b_m, v_fun, x0_s, n_steps,
                           n_warm)
    A_pre = f["B_pre"][1:]                           # rows 1..N-1
    C_pre = _sym(f["P_f_pre"][:-1] - jnp.einsum(
        "tbij,tbjk,tblk->tbil", A_pre, f["P_p_pre"][1:], A_pre))
    m_f_all, m_p_all = f["m_f_all"], f["m_p_all"]
    mean_sim_pre = m_f_all[1:n_steps] + jnp.einsum(
        "tbij,tbj->tbi", A_pre, x_hat[2:] - m_p_all[1:])
    logx_z = live_logpdf_sum(x_hat[-1] - m_f_all[-1], f["P_f_pre"][-1])
    logx_z += live_logpdf_sum(x_hat[1:n_steps] - mean_sim_pre, C_pre)

    # --- observation likelihood at the smoothed means ----------------
    rows = jnp.asarray(np.asarray(obs_ind, dtype=np.int64))
    logy_x = jnp.sum(jax.vmap(
        lambda y_j, x_j, j: obs_ll_s(y_j, x_j, j, **params))(
        obs_data, x_hat[rows], jnp.arange(len(obs_ind))))

    return logy_x + logx_z - logx_yhat


@full_matmul_precision
def daltonng_stationary(key, ode_fun, ode_weight, ode_init,
                        t_min, t_max, n_steps,
                        interrogate,
                        prior_pars,
                        obs_data, obs_times, obs_loglik_i,
                        n_deriv=None, validate=True, **params):
    r"""
    Hoisted-affine :func:`rodeo_tpu.ops.precond.daltonng` for affine
    time-invariant ODEs — NON-GAUSSIAN data likelihoods in the
    large-state regime, completing the five-method inference matrix at
    :math:`d \gg 1`.  Functional parity target:
    ``/root/reference/src/rodeo/inference/dalton.py:849-949``
    (``daltonng``), restricted per the module validity contract plus:

    - ``obs_loglik_i(y_i, x_i, i, **params)`` must have a COORDINATEWISE
      DIAGONAL Hessian in the state (independent per-coordinate
      observation models — Gaussian, Poisson, any GLM observing single
      state coordinates).  The plain path's per-step ``pinv`` (an SVD)
      and eigen-masked backward densities do not compile tractably at
      state dim ~384; the diagonal contract replaces them with
      elementwise inverses and Cholesky factorizations throughout.
    - observation rows must be distinct interior grid rows (no ``t=0``
      observation).
    - the interrogation must carry ZERO measurement noise
      (``interrogate_kramer``/``interrogate_schober``):  the marginal
      pass projects every backward log-density onto the structural
      null-space complement span(H')ᴾ, which is exact only when the
      smoothing covariances are singular along span(H') — i.e.
      ``var_meas == 0``.  ``interrogate_rodeo`` (``var_meas = W Σ W'``)
      violates this; the wrapper probes ``v_fun`` device-side and
      NaN-poisons the returned likelihood on violation instead of
      returning a silently wrong value.

    Both passes carry EXACT covariance recursions (no ``n_warm``
    freezing): the marginal term's masked log-densities project onto
    the exact null space of the singular smoothing covariances, and a
    frozen covariance perturbs those zero eigenvalues to
    :math:`O(\rho^{n_{\text{warm}}})` — unmaskable, so the projection
    blows up (measured: +285 log-lik drift at ``n_warm=16`` on the mild
    d=8 fixture, vs exact-match at full warm-up).  The hoisted affine
    interrogation (no per-step ``jacfwd``/``pinv``) remains the
    large-state win.  Fully differentiable.

    Returns:
        (float): approximate log-likelihood
        :math:`\log p(Y_{0:M} \mid Z_{1:N})`.
    """
    if key is not None:
        raise ValueError(
            "daltonng_stationary requires a deterministic interrogation "
            "(key=None)")
    try:
        obs_times_np = np.asarray(obs_times)
        grid = np.linspace(float(t_min), float(t_max), int(n_steps) + 1)
    except (jax.errors.TracerArrayConversionError,
            jax.errors.ConcretizationTypeError) as e:
        raise ValueError(
            "daltonng_stationary requires concrete (non-traced) "
            "obs_times and grid bounds (close over them instead of "
            "passing them as jit arguments)") from e
    obs_ind = tuple(int(i) for i in np.searchsorted(grid, obs_times_np))
    if any(b <= a for a, b in zip(obs_ind, obs_ind[1:])):
        raise ValueError(
            "daltonng_stationary requires strictly increasing "
            f"observation times mapping to distinct grid rows; got "
            f"{obs_ind}")
    if obs_ind and (obs_ind[0] < 1 or obs_ind[-1] > n_steps):
        raise ValueError(
            f"observation rows {obs_ind} must be interior grid rows "
            f"in [1, {n_steps}]")
    n_warm = int(n_steps)

    from rodeo_tpu.ops.precond import _wrap_obs_loglik
    t_vec, W_s, x0_s, (Q, R) = _scaled_inputs(
        ode_weight, ode_init, prior_pars, t_min, t_max, n_steps, n_deriv)
    wrapped = _wrap_interrogate(interrogate, ode_weight, t_vec)
    dtype = x0_s.dtype
    t1 = t_min + (t_max - t_min) / n_steps

    H, H_inn, b, v_fun, poison = _extract_affine(
        wrapped, ode_fun, W_s, x0_s, t1, t_max, validate, params)

    # zero-measurement-noise contract (round-4 advisor #2): the core's
    # span(H')-perp projection of every backward log-density is exact
    # ONLY when the interrogation carries no measurement noise
    # (kramer/schober: V == 0 identically).  interrogate_rodeo's
    # var_meas = W Sigma W' != 0 makes the smoothing covariances
    # full-rank — the projection would silently drop k_meas dimensions
    # from every logpdf term.  Probe V at zero AND at identity predicted
    # covariance (v_fun is affine in Sigma for every shipped
    # interrogation, so the two probes cover it) and NaN-poison the
    # returned likelihood device-side when either is nonzero.
    nb_g, n_g = x0_s.shape
    eye_g = jnp.broadcast_to(jnp.eye(n_g, dtype=dtype), (nb_g, n_g, n_g))
    noise_probe = jnp.maximum(
        jnp.max(jnp.abs(v_fun(jnp.zeros_like(eye_g)))),
        jnp.max(jnp.abs(v_fun(eye_g))))
    nonzero_noise = noise_probe > jnp.asarray(1e-12, dtype)

    obs_ll_s = _wrap_obs_loglik(obs_loglik_i, t_vec)
    with fast_linalg():
        return poison(_daltonng_stationary_core(
            Q, R, H.astype(dtype), H_inn.astype(dtype), b.astype(dtype),
            v_fun, x0_s, n_steps, n_warm, obs_ind,
            obs_data.astype(dtype), obs_ll_s, params),
            also_if=nonzero_noise)
