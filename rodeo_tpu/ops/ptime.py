r"""
Parallel-in-time Kalman filtering and smoothing via ``jax.lax.associative_scan``.

The reference advances the solver time grid with a strictly sequential
``jax.lax.scan`` (upstream ``rodeo/solve.py:112,291``) — an
:math:`O(N)` span of tiny :math:`q \times q` operations that leaves an
accelerator latency-bound.  Both the Kalman filter and the RTS smoother are
associative
recursions (Särkkä & García-Fernández 2021, *Temporal parallelization of
Bayesian smoothers*), so they can instead run as prefix/suffix combines with
:math:`O(\log N)` sequential depth, where each combine level is one large
batched ``(N, n_block, q, q)`` matmul/solve.

Three entry points:

- :func:`parallel_filter` — exact parallel Kalman filter for an *affine*
  per-step measurement model (all :math:`H_n, d_n, V_n, y_n` known up
  front).
- :func:`parallel_smooth_mv` — exact parallel RTS smoother over stored
  forward-filter outputs.  This is linear regardless of the interrogation,
  so it is a drop-in replacement for the backward pass of
  :func:`rodeo_tpu.solve.solve_mv` (select ``temporal="parallel"``).
- :func:`solve_mv_iterated` — fully parallel-in-time *iterated* solver:
  repeatedly (re-)linearizes the ODE interrogation along the whole current
  trajectory at once, then runs the exact parallel filter+smoother.  Its
  fixed point coincides with the sequential solver's linearization scheme;
  it is exact-in-the-limit rather than step-equivalent, so it is opt-in.

All elements carry a block batch axis and combine with broadcasting ops, so
the associative scan vectorizes over (time-chunk, block) jointly.
"""
import jax
import jax.numpy as jnp

from rodeo_tpu.utils import mtt, mvdot, quadform
from rodeo_tpu.ops.linalg import solve_small, solve_psd
from rodeo_tpu.ops.linalg import full_matmul_precision

__all__ = [
    "parallel_filter",
    "parallel_filter_tv",
    "parallel_smooth_mv",
    "solve_mv_iterated",
]


def _sym(mat):
    """Symmetrize to stop fp drift through repeated combines."""
    return 0.5 * (mat + mtt(mat))


# --- parallel filter ------------------------------------------------------------


def _filter_combine(elem_i, elem_j):
    r"""
    Associative combination of two filtering elements (Särkkä &
    García-Fernández 2021, Lemma 8).  ``elem_i`` precedes ``elem_j``; each is
    the 5-tuple :math:`(A, b, C, \eta, J)` parameterizing
    :math:`p(x_k \mid x_{i-1}, y_{i:k})`.
    """
    A_i, b_i, C_i, eta_i, J_i = elem_i
    A_j, b_j, C_j, eta_j, J_j = elem_j
    s = A_i.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(s, dtype=A_i.dtype), A_i.shape)
    # X = I + C_i J_j ; Z = I + J_j C_i
    X = eye + C_i @ J_j
    Z = eye + J_j @ C_i
    AX = mtt(solve_small(mtt(X), mtt(A_j)))           # A_j X^{-1}
    A = AX @ A_i
    b = mvdot(AX, b_i + mvdot(C_i, eta_j)) + b_j
    C = _sym(AX @ C_i @ mtt(A_j) + C_j)
    AiT_Zinv = mtt(solve_small(mtt(Z), A_i))           # A_i' Z^{-1}
    eta = mvdot(AiT_Zinv, eta_j - mvdot(J_j, b_i)) + eta_i
    J = _sym(AiT_Zinv @ J_j @ A_i + J_i)
    return A, b, C, eta, J


def _filter_elements(mean_init, var_init,
                     prior_weight, prior_var,
                     wgt_meas, mean_meas, var_meas, x_meas):
    r"""
    Build the per-step filtering elements for the associative scan.

    Step :math:`k` (k = 1..N) covers the transition
    :math:`x_k = Q x_{k-1} + R^{1/2}\epsilon` and the measurement
    :math:`y_k = d_k + H_k x_k + V_k^{1/2}\eta`.  Generic elements assume an
    unknown :math:`x_{k-1}`; the first element instead folds in the known
    initial distribution :math:`N(m_0, P_0)`.

    Shapes: per-step measurement arrays lead with the time axis
    ``(n_steps, n_block, ...)``; the prior and init are per-block.
    """
    Q, R = prior_weight, prior_var
    H, d, V, y = wgt_meas, mean_meas, var_meas, x_meas
    resid = y - d

    # generic elements (time axis broadcasting against per-block Q, R)
    S = quadform(H, R) + V                                   # (N, nb, m, m)
    gain = mtt(solve_psd(S, H @ R))                   # R H' S^{-1}
    A = (Q - gain @ (H @ Q))                                 # (I - K H) Q
    b = mvdot(gain, resid)
    C = _sym(R - gain @ (H @ R))
    HQ = H @ Q
    SinvHQ = solve_psd(S, HQ)                         # S^{-1} H Q
    eta = mvdot(mtt(HQ), solve_psd(S, resid[..., None])[..., 0])
    J = _sym(mtt(HQ) @ SinvHQ)

    # first element: condition on the known initial distribution
    m1_pred = mvdot(Q, mean_init)
    P1_pred = quadform(Q, var_init) + R
    S1 = quadform(H[0], P1_pred) + V[0]
    gain1 = mtt(solve_psd(S1, H[0] @ P1_pred))
    b1 = m1_pred + mvdot(gain1, resid[0] - mvdot(H[0], m1_pred))
    C1 = _sym(P1_pred - gain1 @ (H[0] @ P1_pred))
    A = A.at[0].set(0.0)
    b = b.at[0].set(b1)
    C = C.at[0].set(C1)
    return A, b, C, eta, J


@full_matmul_precision
def parallel_filter(mean_init, var_init,
                    prior_weight, prior_var,
                    wgt_meas, mean_meas, var_meas, x_meas):
    r"""
    Exact parallel-in-time Kalman filter for an affine measurement model.

    Equivalent (up to fp reordering) to scanning
    ``kalmantv.standard.filter`` over the time axis, but with
    :math:`O(\log N)` sequential depth.

    Args:
        mean_init (ndarray(n_block, s)): Initial state mean :math:`m_0`.
        var_init (ndarray(n_block, s, s)): Initial state variance
            :math:`P_0` (zero for the ODE solver).
        prior_weight (ndarray(n_block, s, s)): Transition :math:`Q`.
        prior_var (ndarray(n_block, s, s)): Process noise :math:`R`.
        wgt_meas (ndarray(n_steps, n_block, m, s)): Per-step :math:`H_k`.
        mean_meas (ndarray(n_steps, n_block, m)): Per-step offsets
            :math:`d_k`.
        var_meas (ndarray(n_steps, n_block, m, m)): Per-step noise
            :math:`V_k`.
        x_meas (ndarray(n_steps, n_block, m)): Per-step observations
            :math:`y_k`.

    Returns:
        (dict): ``state_filt`` and ``state_pred`` tuples of stacked
        ``(n_steps+1, n_block, ...)`` means/variances, with the initial
        state prepended — the same pytree contract as
        ``rodeo_tpu.solve._solve_filter``.
    """
    elems = _filter_elements(
        mean_init, var_init, prior_weight, prior_var,
        wgt_meas, mean_meas, var_meas, x_meas)
    _, mean_filt, var_filt, _, _ = jax.lax.associative_scan(
        _filter_combine, elems)
    # predictions from the filtered states one step earlier
    mean_prev = jnp.concatenate([mean_init[None], mean_filt[:-1]])
    var_prev = jnp.concatenate([var_init[None], var_filt[:-1]])
    mean_pred = mvdot(prior_weight, mean_prev)
    var_pred = quadform(prior_weight, var_prev) + prior_var
    out_filt = (
        jnp.concatenate([mean_init[None], mean_filt]),
        jnp.concatenate([var_init[None], var_filt]),
    )
    out_pred = (
        jnp.concatenate([mean_init[None], mean_pred]),
        jnp.concatenate([var_init[None], var_pred]),
    )
    return {"state_filt": out_filt, "state_pred": out_pred}


def _filter_elements_tv(mean_init, var_init,
                        wgt_state, mean_state, var_state,
                        wgt_meas, mean_meas, var_meas, x_meas):
    r"""
    Per-step filtering elements for a fully time-varying affine model
    :math:`x_k = Q_k x_{k-1} + c_k + R_k^{1/2}\epsilon`,
    :math:`y_k = d_k + H_k x_k + V_k^{1/2}\eta` (all arrays lead with the
    time axis).  Same 5-tuple contract as :func:`_filter_elements`.
    """
    Q, c, R = wgt_state, mean_state, var_state
    H, d, V, y = wgt_meas, mean_meas, var_meas, x_meas
    resid = y - d - mvdot(H, c)

    S = quadform(H, R) + V
    gain = mtt(solve_psd(S, H @ R))                 # R H' S^{-1}
    A = Q - gain @ (H @ Q)
    b = c + mvdot(gain, resid)
    C = _sym(R - gain @ (H @ R))
    HQ = H @ Q
    eta = mvdot(mtt(HQ), solve_psd(S, resid[..., None])[..., 0])
    J = _sym(mtt(HQ) @ solve_psd(S, HQ))

    # first element: condition on the known initial distribution
    m1 = mvdot(Q[0], mean_init) + c[0]
    P1 = quadform(Q[0], var_init) + R[0]
    S1 = quadform(H[0], P1) + V[0]
    gain1 = mtt(solve_psd(S1, H[0] @ P1))
    b1 = m1 + mvdot(gain1, y[0] - d[0] - mvdot(H[0], m1))
    C1 = _sym(P1 - gain1 @ (H[0] @ P1))
    A = A.at[0].set(0.0)
    b = b.at[0].set(b1)
    C = C.at[0].set(C1)
    return A, b, C, eta, J


@full_matmul_precision
def parallel_filter_tv(mean_init, var_init,
                       wgt_state, mean_state, var_state,
                       wgt_meas, mean_meas, var_meas, x_meas):
    r"""
    Exact parallel-in-time Kalman filter for a fully *time-varying* affine
    state-space model (per-step transitions AND measurements), with
    :math:`O(\log N)` sequential depth.  Used for linear conditional chains
    such as the fenrir backward pass, whose per-step transition
    :math:`(A_n, b_n, C_n)` comes from ``smooth_cond``.

    Args:
        mean_init (ndarray(n_block, s)): Initial state mean.
        var_init (ndarray(n_block, s, s)): Initial state variance.
        wgt_state (ndarray(n_steps, n_block, s, s)): Per-step transitions
            :math:`Q_k`.
        mean_state (ndarray(n_steps, n_block, s)): Per-step offsets
            :math:`c_k`.
        var_state (ndarray(n_steps, n_block, s, s)): Per-step process noise
            :math:`R_k`.
        wgt_meas, mean_meas, var_meas, x_meas: Per-step measurement model,
            as in :func:`parallel_filter`.

    Returns:
        (dict): ``state_filt`` / ``state_pred`` stacked
        ``(n_steps+1, n_block, ...)`` pytree (initial state prepended) —
        the ``rodeo_tpu.solve._solve_filter`` contract.
    """
    elems = _filter_elements_tv(
        mean_init, var_init, wgt_state, mean_state, var_state,
        wgt_meas, mean_meas, var_meas, x_meas)
    _, mean_filt, var_filt, _, _ = jax.lax.associative_scan(
        _filter_combine, elems)
    mean_prev = jnp.concatenate([mean_init[None], mean_filt[:-1]])
    var_prev = jnp.concatenate([var_init[None], var_filt[:-1]])
    mean_pred = mvdot(wgt_state, mean_prev) + mean_state
    var_pred = quadform(wgt_state, var_prev) + var_state
    return {
        "state_filt": (
            jnp.concatenate([mean_init[None], mean_filt]),
            jnp.concatenate([var_init[None], var_filt]),
        ),
        "state_pred": (
            jnp.concatenate([mean_init[None], mean_pred]),
            jnp.concatenate([var_init[None], var_pred]),
        ),
    }


# --- parallel smoother ----------------------------------------------------------


def _smooth_combine(elem_i, elem_j):
    r"""
    Associative combination of two smoothing elements (Särkkä &
    García-Fernández 2021, Lemma 10).  ``elem_i`` precedes ``elem_j`` in
    time; the suffix combine of :math:`(E, g, L)` yields the smoothed
    mean/variance directly.
    """
    E_i, g_i, L_i = elem_i
    E_j, g_j, L_j = elem_j
    E = E_i @ E_j
    g = g_i + mvdot(E_i, g_j)
    L = _sym(L_i + E_i @ L_j @ mtt(E_i))
    return E, g, L


def _smooth_elements(mean_state_filt, var_state_filt,
                     mean_state_pred, var_state_pred, prior_weight):
    r"""
    Per-step RTS smoothing elements :math:`(E_k, g_k, L_k)` for the suffix
    associative scan, built from stored forward-filter outputs (covariance
    form).  Elements cover steps :math:`k = 1..N`; the terminal element
    pins the filtered terminal state (:math:`E_N = 0`).  Everything is
    elementwise over the time axis except one unit shift (``filt[k]``
    pairs with ``pred[k+1]``), so the construction shards cleanly over a
    time-partitioned device mesh.
    """
    n_steps = mean_state_filt.shape[0] - 1
    # smoothing elements for k = 1..N-1 : gain G_k = P_k Q' P_{k+1|k}^{-1}
    P_filt = var_state_filt[1:n_steps]          # (N-1, nb, s, s)
    m_filt = mean_state_filt[1:n_steps]
    P_pred = var_state_pred[2:n_steps + 1]
    m_pred = mean_state_pred[2:n_steps + 1]
    PQt = P_filt @ mtt(prior_weight)
    gain = mtt(solve_psd(P_pred, mtt(PQt)))
    g = m_filt - mvdot(gain, m_pred)
    L = _sym(P_filt - gain @ P_pred @ mtt(gain))
    # terminal element: the filtered terminal state
    E = jnp.concatenate([gain, jnp.zeros_like(gain[:1])])
    g = jnp.concatenate([g, mean_state_filt[n_steps][None]])
    L = jnp.concatenate([L, var_state_filt[n_steps][None]])
    return E, g, L


def _psd_sqrt(mat):
    """Symmetric PSD square root via eigendecomposition (clamped at zero).

    Used to return factors in square-root mode; any factor with
    ``F F' = mat`` satisfies the kernel contract."""
    w, v = jnp.linalg.eigh(mat)
    w = jnp.maximum(w, 0.0)
    return v * jnp.sqrt(w)[..., None, :]


@full_matmul_precision
def parallel_smooth_mv(ode_init,
                       mean_state_filt, var_state_filt,
                       mean_state_pred, var_state_pred,
                       prior_weight, prior_var,
                       kalman_type="standard"):
    r"""
    Exact parallel-in-time RTS smoother over stored forward-filter outputs.

    Produces the same ``(mean_state_smooth, var_state_smooth)`` as the
    reverse sequential scan of ``solve.py:258-301`` (up to fp reordering),
    including the conventions: the initial state is pinned to ``ode_init``
    with zero variance and the terminal state equals the filtered state.

    In ``square-root`` mode the variance inputs are factors; covariances are
    formed internally and the returned variance is a symmetric PSD factor.

    Args:
        ode_init (ndarray(n_block, s)): Known initial state.
        mean_state_filt, var_state_filt: stacked ``(n_steps+1, n_block, ...)``
            forward filtered moments.
        mean_state_pred, var_state_pred: stacked forward predicted moments.
        prior_weight, prior_var (ndarray(n_block, s, s)): :math:`Q, R`
            (variance scale in standard mode, factor scale in square-root
            mode).
        kalman_type (str): ``"standard"`` or ``"square-root"``.

    Returns:
        (tuple): ``mean_state_smooth``, ``var_state_smooth`` of shapes
        ``(n_steps+1, n_block, s[, s])``.
    """
    sqrt_mode = kalman_type == "square-root"
    if sqrt_mode:
        var_state_filt = var_state_filt @ mtt(var_state_filt)
        var_state_pred = var_state_pred @ mtt(var_state_pred)
    elif kalman_type != "standard":
        raise NotImplementedError(
            f"unknown kalman_type {kalman_type!r}")

    E, g, L = _smooth_elements(
        mean_state_filt, var_state_filt,
        mean_state_pred, var_state_pred, prior_weight)
    # NB: with reverse=True, associative_scan feeds the operator its
    # arguments in (later, earlier) order; swap so that the suffix combine
    # composes earlier-first as _smooth_combine expects.
    _, mean_smooth, var_smooth = jax.lax.associative_scan(
        lambda a, b: _smooth_combine(b, a), (E, g, L), reverse=True)

    zero_var = jnp.zeros_like(var_state_filt[:1])
    mean_out = jnp.concatenate([ode_init[None], mean_smooth])
    var_out = jnp.concatenate([zero_var, var_smooth])
    if sqrt_mode:
        var_out = _psd_sqrt(var_out)
    return mean_out, var_out


# --- iterated parallel solver ----------------------------------------------------


def _compose_prior(prior_weight, prior_var, k):
    r"""
    Exact ``k``-step composition of a stationary Gauss-Markov transition:
    :math:`Q_k = Q^k`, :math:`R_k = \sum_{i=0}^{k-1} Q^i R (Q^i)'`,
    computed by binary doubling (``k`` is a static Python int).
    """
    eye = jnp.broadcast_to(
        jnp.eye(prior_weight.shape[-1], dtype=prior_weight.dtype),
        prior_weight.shape)
    Qc, Rc = eye, jnp.zeros_like(prior_var)      # identity = 0 steps
    Qa, Ra = prior_weight, prior_var             # 1 step
    while k:
        if k & 1:
            # apply Qa-steps after Qc-steps
            Qc, Rc = Qa @ Qc, quadform(Qa, Rc) + Ra
        k >>= 1
        if k:
            Qa, Ra = Qa @ Qa, quadform(Qa, Ra) + Ra
    return Qc, Rc


@full_matmul_precision
def solve_mv_iterated(key, ode_fun, ode_weight, ode_init,
                      t_min, t_max, n_steps,
                      interrogate,
                      prior_pars,
                      n_iter=20, warm_start=True, n_coarse=64,
                      window_size=None, window_warm="global", **params):
    r"""
    Fully parallel-in-time probabilistic ODE solve by iterated global
    linearization (parallel-EKS style; cf. Bosch et al 2023,
    *Parallel-in-time probabilistic numerical ODE solvers*).

    Each iteration interrogates the ODE at *every* step of the current
    predicted trajectory at once (one vmapped call — embarrassingly
    parallel), then runs the exact :func:`parallel_filter` and a final
    :func:`parallel_smooth_mv`.  At the fixed point, the per-step
    linearization equals the one the sequential solver would have produced,
    so the result converges to the sequential solution of the same
    interrogation scheme.

    The per-iteration cost is :math:`O(\log N)` sequential depth, so total
    depth is :math:`O(K \log N)` — for long grids this beats the
    :math:`O(N)` sequential scan by orders of magnitude.

    .. warning:: Use a **first-order** interrogation
       (:func:`~rodeo_tpu.interrogate.interrogate_kramer`).  With
       zero-order schemes the global relinearization degenerates to a plain
       Picard iteration whose map has spectral radius > 1 on stiff or
       long-horizon problems, so it diverges even from a warm start (this
       is why parallel-in-time probabilistic solvers in the literature use
       EK1 linearization).

    The global-relinearization iteration is only *locally* convergent, so
    the trajectory is warm-started from a coarse sequential solve
    (``n_coarse`` steps, exact ``k``-step-composed prior) interpolated onto
    the fine grid — an :math:`O(n_{coarse})` sequential prefix that puts the
    iteration inside its contraction basin.

    Args:
        n_iter (int): Number of linearization sweeps.  The final sweep's
            filter output feeds one exact parallel smoother.
        warm_start (bool): Initialize from a coarse sequential solve
            (recommended; a cold constant-trajectory start diverges on
            stiff/chaotic systems).
        n_coarse (int): Target number of coarse warm-start steps.
        window_size (int | None): If set, iterate over time *windows* of
            this many steps (must divide ``n_steps``): windows are chained
            sequentially through their filtered boundary states while each
            window's relinearization runs parallel-in-time.  This bounds
            the transient growth of the relinearization map, making the
            iteration robust on long/chaotic horizons where the global
            (``None``) mode needs many sweeps or fails to contract.
            Sequential depth is :math:`O((N/L)\,K \log L)`.
        window_warm (str): How each window's linearization trajectory is
            initialized.  ``"global"`` (default): from the coarse
            warm-start interpolation — best when ``n_coarse`` resolves the
            dynamics (few sweeps needed), but a diverged coarse solve
            (chaotic horizon, coarse ``n_coarse``) poisons every window.
            ``"boundary"``: constant at the window's carried boundary
            state — no sequential coarse prefix at all, converges exactly
            on chaotic horizons given short windows (~100 steps) and
            enough sweeps (``n_iter``~40); unconverged window error is
            amplified by the Lyapunov factor of each later window.
        (other arguments as in :func:`rodeo_tpu.solve.solve_mv`; only the
        ``"standard"`` Kalman form is used internally, and the
        interrogation must be deterministic.)

    Returns:
        (tuple): ``mean_state_smooth``, ``var_state_smooth`` — same contract
        as :func:`rodeo_tpu.solve.solve_mv`.
    """
    prior_weight, prior_var = prior_pars
    n_block, n_bmeas, n_bstate = ode_weight.shape
    dtype = ode_init.dtype
    var_init = jnp.zeros((n_block, n_bstate, n_bstate), dtype=dtype)

    tgrid = t_min + (t_max - t_min) * (jnp.arange(n_steps) + 1) / n_steps
    if key is not None:
        keys = jax.random.split(key, num=n_steps)
    else:
        keys = jnp.zeros(n_steps)

    def interrogate_all(mean_pred, var_pred):
        """Linearize every step of the trajectory at once."""
        def one(key_n, t, m, v):
            return interrogate(
                key=key_n, ode_fun=ode_fun, ode_weight=ode_weight, t=t,
                mean_state_pred=m, var_state_pred=v, **params)
        return jax.vmap(one)(keys, tgrid, mean_pred, var_pred)

    if window_warm not in ("global", "boundary"):
        raise ValueError(
            f"window_warm must be 'global' or 'boundary', got "
            f"{window_warm!r}")
    if (window_warm == "boundary" and window_size is not None
            and window_size < n_steps):
        # boundary-mode windows need no global warm start: each window is
        # warm-started from its own carried boundary state (below), which
        # stays accurate even when a coarse global solve would have
        # diverged (chaotic systems) — and skipping the sequential coarse
        # prefix makes the whole pipeline depth O((N/L) K log L)
        warm_start = False

    var_pred = jnp.broadcast_to(
        prior_var, (n_steps,) + prior_var.shape).astype(dtype)
    if warm_start:
        from rodeo_tpu.solve import solve_mv as _solve_mv_seq
        # for n_steps <= n_coarse the warm start runs at full resolution
        # (cf = 1), which already sits at the fixed point
        cf = max(1, -(-n_steps // n_coarse))        # coarse factor (ceil)
        n_c = n_steps // cf
        dt = (t_max - t_min) / n_steps
        coarse_prior = _compose_prior(prior_weight, prior_var, cf)
        mu_c, _ = _solve_mv_seq(
            key=key, ode_fun=ode_fun, ode_weight=ode_weight,
            ode_init=ode_init, t_min=t_min, t_max=t_min + n_c * cf * dt,
            n_steps=n_c, interrogate=interrogate, prior_pars=coarse_prior,
            **params)
        t_c = t_min + (jnp.arange(n_c + 1)) * cf * dt
        # linear interpolation of every (block, state) component onto the
        # fine prediction grid (clamped at the ends)
        interp = jax.vmap(jax.vmap(
            lambda ys: jnp.interp(tgrid, t_c, ys),
            in_axes=-1, out_axes=-1), in_axes=1, out_axes=1)
        mean_pred = interp(mu_c)
    else:
        # cold start: constant trajectory at the initial state
        mean_pred = jnp.broadcast_to(
            ode_init, (n_steps,) + ode_init.shape).astype(dtype)
    x_meas = jnp.zeros((n_steps, n_block, n_bmeas), dtype=dtype)

    if window_size is None or window_size >= n_steps:
        n_win, win = 1, n_steps
    else:
        if n_steps % window_size:
            raise ValueError(
                f"window_size ({window_size}) must divide n_steps "
                f"({n_steps})")
        n_win, win = n_steps // window_size, window_size

    def _win_reshape(arr):
        return arr.reshape((n_win, win) + arr.shape[1:])

    def window_body(carry, win_xs):
        """Iterated parallel filter over one time window, chained causally
        from the previous window's filtered terminal state.  The window's
        linearization trajectory is warm-started CONSTANT at the carried
        boundary state — accurate by construction at the left edge, and
        within the relinearization iteration's contraction basin whenever
        the window is short relative to the system's Lyapunov time (the
        global coarse-solve interpolation used previously diverges from
        the true trajectory on chaotic systems, poisoning every window
        after the first)."""
        m_b, P_b = carry
        w_keys, w_tgrid, w_mean_pred, w_var_pred = win_xs
        if n_win > 1 and window_warm == "boundary":
            w_mean_pred = jnp.broadcast_to(m_b, (win,) + m_b.shape)

        def lin_all(mean_pred, var_pred):
            def one(key_n, t, m, v):
                return interrogate(
                    key=key_n, ode_fun=ode_fun, ode_weight=ode_weight, t=t,
                    mean_state_pred=m, var_state_pred=v, **params)
            return jax.vmap(one)(w_keys, w_tgrid, mean_pred, var_pred)

        def run_filter(mean_pred, var_pred):
            wgt_meas, mean_meas, var_meas = lin_all(mean_pred, var_pred)
            return parallel_filter(
                mean_init=m_b, var_init=P_b,
                prior_weight=prior_weight, prior_var=prior_var,
                wgt_meas=ode_weight + wgt_meas,
                mean_meas=mean_meas, var_meas=var_meas,
                x_meas=x_meas[:win])

        def sweep(carry, _):
            out = run_filter(*carry)
            # the relinearization iterate can transiently leave the
            # contraction basin before re-converging; on polynomial
            # vector fields that transient overflows (-> NaN, which then
            # locks in).  Clamping the next linearization trajectory to a
            # finite box keeps the iteration recoverable without moving
            # the fixed point.  The bound must never bind on legitimate
            # states: Taylor-preconditioned coordinates scale means by
            # dt^{-(q-i)}/sqrt(dt) (~1e9 for fine grids), so clamp at
            # 1e12 — still cube-safe in float32 (1e36 < 3.4e38).
            m_new = jnp.clip(jnp.nan_to_num(out["state_pred"][0][1:],
                                            nan=0.0, posinf=1e12,
                                            neginf=-1e12),
                             -1e12, 1e12)
            # the variance iterate must be sanitized too: a NaN/Inf in the
            # carried variance would otherwise lock in across sweeps and
            # defeat the recoverability the mean clamp provides.  Fall back
            # to the (PSD by construction) prior variance where non-finite.
            v_raw = out["state_pred"][1][1:]
            v_new = jnp.where(
                jnp.all(jnp.isfinite(v_raw), axis=(-1, -2), keepdims=True),
                v_raw, jnp.broadcast_to(prior_var, v_raw.shape))
            return (m_new, v_new), None

        (mean_pred, var_pred), _ = jax.lax.scan(
            sweep, (w_mean_pred, w_var_pred), None, length=n_iter)
        out = run_filter(mean_pred, var_pred)
        new_carry = (out["state_filt"][0][-1], out["state_filt"][1][-1])
        stack = {
            "state_filt": (out["state_filt"][0][1:], out["state_filt"][1][1:]),
            "state_pred": (out["state_pred"][0][1:], out["state_pred"][1][1:]),
        }
        return new_carry, stack

    win_xs = (_win_reshape(keys), _win_reshape(tgrid),
              _win_reshape(mean_pred), _win_reshape(var_pred))
    _, stacked = jax.lax.scan(window_body, (ode_init, var_init), win_xs)
    # flatten (n_win, win, ...) back to the full time axis and prepend init
    mean_filt, var_filt = jax.tree_util.tree_map(
        lambda a: a.reshape((n_steps,) + a.shape[2:]), stacked["state_filt"])
    mean_predo, var_predo = jax.tree_util.tree_map(
        lambda a: a.reshape((n_steps,) + a.shape[2:]), stacked["state_pred"])

    # exact parallel smoother over the whole horizon
    return parallel_smooth_mv(
        ode_init=ode_init,
        mean_state_filt=jnp.concatenate([ode_init[None], mean_filt]),
        var_state_filt=jnp.concatenate([var_init[None], var_filt]),
        mean_state_pred=jnp.concatenate([ode_init[None], mean_predo]),
        var_state_pred=jnp.concatenate([var_init[None], var_predo]),
        prior_weight=prior_weight,
        prior_var=prior_var,
        kalman_type="standard")
