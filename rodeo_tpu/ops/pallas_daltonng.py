r"""
Fused non-Gaussian DALTON likelihood (lane-batched).

``daltonng`` (``rodeo_tpu/inference/dalton.py``, reference
``dalton.py:851-949``) assembles ``logy_x + logx_z - logx_yhat`` from two
forward filters and two (linear) smoothing passes.  The XLA path runs
three sequential 4k-step scans per evaluation; this module restructures
the whole pipeline:

* **two fused lane-batched forward filters** — the Laplace-linearized
  filter (below: the fused EK filter step plus masked per-component
  pseudo-observation updates) and the plain ODE filter
  (:func:`rodeo_tpu.ops.pallas_kalman.fused_filter_batch`) — both
  lane-batched, both storing the per-step moments the smoothing passes
  need;
* **backward-kernel parameters** ``(A, b, C)`` as one batched gain
  computation over the whole time axis
  (:func:`rodeo_tpu.ops.pallas_kalman._gain_cols_batched`);
* the smoothed-mean recursion :math:`m_n = A_n m_{n+1} + b_n` as an
  **exact associative scan** (suffix composition of affine maps,
  :math:`O(\log N)` depth of batched matmuls — no sequential scan);
* every log-density as **one batched closed-form pass** (the
  ``logx_yhat`` quadratic form vanishes identically at the smoothed
  mean, leaving pure log-determinant sums).

Everything runs in Taylor-scaled coordinates; the state-space
change-of-variables Jacobians of ``logx_z`` and ``logx_yhat`` cancel
exactly in the difference, so the returned value matches the original
coordinates (same argument as ``precond.daltonng``).

Supported configuration (XLA path otherwise): ``n_bmeas == 1``, standard
form, EK1/EK0 interrogation, observations on grid points, block-constant
transition (IBM prior), and **component-independent** observation models

.. math:: \ell_i(y_i, x) = \sum_{b,j} \ell_{ij}(y_{ib}, x_{bj})

whose per-component contributions the user supplies as an
elementwise callable (``obs_comp_flat`` below); the Laplace gradient and
(diagonal) Hessian are derived inside the step by nested forward-mode
``jax.jvp`` — no user-written derivatives.
"""
import functools

import jax
import jax.numpy as jnp

from rodeo_tpu.ops.flat_rows import flat_call
from rodeo_tpu.ops.precond import taylor_scale, scale_prior
from rodeo_tpu.ops.pallas_kalman import (
    _tri_idx, _pack_tri, _unpack_tri, _sym_quadform, _matvec, _acc,
    _static_scaled_qconst, p_cols_at, _gain_cols_batched,
    fused_filter_batch)
from rodeo_tpu.ops.scan import scan_steps

__all__ = ["daltonng_fused_batch", "daltonng_fused_batch_grad"]

_LOG2PI = 1.8378770664093453


def _comp_grad_hess(obs_comp_flat, j, y_cols, x_col, th, iobs):
    """Elementwise first/second derivative of the user's per-component
    observation loglik via nested jvp (jvp of jnp column ops is jnp
    column ops)."""
    ones = jnp.ones_like(x_col)

    def f(x):
        return obs_comp_flat(y_cols, x, j, th, iobs)

    def df(x):
        return jax.jvp(f, (x,), (ones,))[1]

    g = df(x_col)
    h = jax.jvp(df, (x_col,), (ones,))[1]
    return g, h

def _filter_nn_step_pure(ode_flat, jac_flat, obs_comp_flat, obs_dims,
                         mode, q, where, pairs, q_const,
                         R_cols, W_cols, tv_cols, t_n,
                         y_cols, iobs, mask):
    """Pure per-step Laplace-linearized DALTON filter update: the fused
    EK filter step (predict / interrogate / ODE update) followed by masked
    scalar pseudo-observation updates, one per observed state component
    (sequential measurement processing == the reference's stacked joint
    update, since the ODE and pseudo-obs noises are independent).  The
    linearization point is the PREDICTED mean in original coordinates,
    matching the reference's stacked joint update at mean_state_pred
    (upstream ``dalton.py:613-622``).  The observation data
    (y, iobs, mask) are theta-independent and closed over; theta flows
    through the ODE fields AND the user observation loglik."""

    def step(m_cols, p_cols, th):
        m_cols, p_cols = list(m_cols), list(p_cols)
        mp_cols = _matvec(q, q_const, m_cols)
        pp_cols = _sym_quadform(q, q_const, p_cols, where)
        pp_cols = [pp_cols[k] + R_cols[k] for k in range(len(pp_cols))]
        x_cols = [mp_cols[j] * tv_cols[j] for j in range(q)]
        f0 = flat_call(ode_flat, x_cols, th, t_n)
        jd_cols = flat_call(jac_flat, x_cols, th, t_n) \
            if mode == "kramer" else [None] * q
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
        if mode in ("rodeo",):
            S = S + S
        inv_S = 1.0 / S
        gain = [PH_cols[i] * inv_S for i in range(q)]
        mf_cols = [mp_cols[i] + gain[i] * z for i in range(q)]
        IKW = [[(1.0 if i == j else 0.0) - gain[i] * H_cols[j]
                for j in range(q)] for i in range(q)]
        pf_cols = _sym_quadform(q, IKW, pp_cols, where)
        if mode in ("rodeo",):
            V = S * 0.5
            pf_cols = [pf_cols[k] + gain[i] * gain[j] * V
                       for k, (i, j) in enumerate(pairs)]
        for j in obs_dims:
            g_j, h_j = _comp_grad_hess(
                obs_comp_flat, j, y_cols, x_cols[j], th, iobs)
            vhat = -1.0 / h_j
            zo = (x_cols[j] + vhat * g_j) - tv_cols[j] * mf_cols[j]
            PD = [p_cols_at(pf_cols, where, i, j) * tv_cols[j]
                  for i in range(q)]
            So = vhat + tv_cols[j] * PD[j]
            K = [PD[i] * (mask / So) for i in range(q)]
            mf_cols = [mf_cols[i] + K[i] * zo for i in range(q)]
            IKD = [[(1.0 if i == l else 0.0)
                    - (K[i] * tv_cols[j] if l == j else 0.0)
                    for l in range(q)] for i in range(q)]
            pj = _sym_quadform(q, IKD, pf_cols, where)
            pf_cols = [pj[kk] + K[i] * K[l] * vhat
                       for kk, (i, l) in enumerate(pairs)]
        return (tuple(mf_cols), tuple(pf_cols),
                tuple(mp_cols), tuple(pp_cols))

    return step


def _filter_nn_batch_tan(ode_flat, jac_flat, obs_comp_flat, obs_dims,
                         mode, n_tan, n_steps, Qs, Rs, W_s, x0_lanes,
                         theta_lanes, tgrid, t_vec, y_k, iobs_grid,
                         mask_grid, q_const):
    """Laplace-linearized DALTON forward filter, lane-batched, carrying
    the primal state plus ``n_tan`` tangent copies (one `jax.jvp` of the
    pure update per theta basis direction; the tangent of the Laplace
    linearization involves THIRD derivatives of the user observation
    loglik, all derived by nesting forward mode).  Outputs stack primal +
    tangents on the d axis: (n_steps, (1+n_tan)*q | *n_tri, nb, B)."""
    del Qs
    q, n_block, n_lane = x0_lanes.shape
    n_ydim = y_k.shape[1]
    pairs, where = _tri_idx(q)
    n_tri = len(pairs)
    R_packed = _pack_tri(Rs, pairs).astype(jnp.float32)
    W = W_s.astype(jnp.float32)
    R_cols = [R_packed[:, k:k + 1] for k in range(n_tri)]
    W_cols = [W[:, j:j + 1] for j in range(q)]
    tv_cols = [t_vec[j].astype(jnp.float32) for j in range(q)]
    th_val = theta_lanes.astype(jnp.float32)
    n_theta = th_val.shape[0]
    dths = [jnp.concatenate([jnp.ones_like(th_val[0:1]) if i == k
                             else jnp.zeros_like(th_val[0:1])
                             for i in range(n_theta)], axis=0)
            for k in range(n_tan)]

    def step(carry, x_t):
        m_aug, p_aug = carry
        t_n, y_t, iobs, mask = x_t
        pure = _filter_nn_step_pure(
            ode_flat, jac_flat, obs_comp_flat, tuple(obs_dims), mode, q,
            where, pairs, q_const, R_cols, W_cols, tv_cols, t_n,
            [y_t[d] for d in range(n_ydim)], iobs, mask)
        args = (tuple(m_aug[:q]), tuple(p_aug[:n_tri]), th_val)
        outs = [pure(*args)]
        for k in range(n_tan):
            tans = (tuple(m_aug[(1 + k) * q:(2 + k) * q]),
                    tuple(p_aug[(1 + k) * n_tri:(2 + k) * n_tri]), dths[k])
            outs.append(jax.jvp(pure, args, tans)[1])
        ys = tuple([c for o in outs for c in o[s]] for s in range(4))
        return (ys[0], ys[1]), ys

    zero = jnp.zeros((n_block, n_lane), jnp.float32)
    carry0 = (list(x0_lanes.astype(jnp.float32)) + [zero] * (n_tan * q),
              [zero] * ((1 + n_tan) * n_tri))
    _, outs = scan_steps(step, carry0,
                         (tgrid.astype(jnp.float32), y_k,
                          iobs_grid[:, 0], mask_grid[:, 0]))
    return outs


def _cond_params_cols(q, n_tri, q_const, Rs, mf, pf, mp, pp):
    """Backward-kernel parameters (A, b, C) for steps 1..N-1 from
    column-layout filter moments (T, d, nb, B), as stacked arrays
    A (T-1, q, q, nb, B), b (T-1, q, nb, B), C packed (T-1, n_tri, nb, B).
    """
    pairs, _ = _tri_idx(q)
    R_packed = _pack_tri(Rs, pairs)
    R_cols_b = [R_packed[None, :, k, None] for k in range(n_tri)]
    mf_cols = [mf[:-1, j] for j in range(q)]
    pf_cols = [pf[:-1, k] for k in range(n_tri)]
    mpn_cols = [mp[1:, j] for j in range(q)]
    ppn_cols = [pp[1:, k] for k in range(n_tri)]
    G, g, L = _gain_cols_batched(q, n_tri, q_const, R_cols_b,
                                 mf_cols, pf_cols, mpn_cols, ppn_cols)
    G_k = jnp.stack([G[i][j] for i in range(q) for j in range(q)],
                    axis=1)                           # (T-1, q*q, nb, B)
    b_k = jnp.stack(g, axis=1)                        # (T-1, q, nb, B)
    C_k = jnp.stack(L, axis=1)                        # (T-1, n_tri, nb, B)
    return G_k, b_k, C_k


def _suffix_means(G_k, b_k, C_k, m_term, p_term):
    """Smoothed-mean recursion ``m_n = G_n m_{n+1} + b_n`` via the shared
    lane-batched backward recursion."""
    from rodeo_tpu.ops.pallas_kalman import smoother_recursion_batch
    ms, _ = smoother_recursion_batch(b_k, G_k, C_k, m_term, p_term)
    return ms


def _masked_eigh(C, q):
    """Eigendecomposition of packed (T, n_tri, nb, B) covariances with a
    RELATIVE degenerate-direction mask.

    The smoothing-pass covariances of the diffuse-prior configs are
    numerically singular (condition numbers beyond 1e10): the reference
    handles them with an eigen-masked logpdf that DROPS near-null
    directions (``utils.multivariate_normal_logpdf``, upstream
    ``utils.py:60-78``) — pseudo-inverse quadratic form, determinant over
    the kept spectrum.  Closed-form inverses/determinants are meaningless
    there, so this path pays for a batched ``eigh``.  The mask threshold
    is relative (100 eps of the dtype), i.e. directions the floating
    format cannot resolve are treated as exact degeneracies."""
    pairs, _ = _tri_idx(q)
    dense = _unpack_tri(jnp.moveaxis(C, 1, -1), q, pairs)  # (T,nb,B,q,q)
    if q <= 3:
        # closed-form elementwise eigendecomposition: jnp.linalg.eigh of
        # millions of tiny matrices is an iterative routine
        from rodeo_tpu.ops.linalg import sym_eigh_small
        w, v = sym_eigh_small(dense)
    else:
        w, v = jnp.linalg.eigh(dense)
    tol = 100.0 * jnp.asarray(jnp.finfo(dense.dtype).eps, dense.dtype)
    wmax = jnp.maximum(jnp.max(jnp.abs(w), axis=-1, keepdims=True),
                       1e-30)
    keep = w > tol * wmax
    if q == 3:
        # Determinant-based refinement of the SMALLEST eigenvalue — the
        # 3x3 generalization of the 2x2 branch in
        # ``utils._mvn_logpdf_pieces``.  Any eigenvalue algorithm (the
        # closed-form cubic above, lapack eigh alike) returns the small
        # eigenvalue of a widely-split spectrum with ~eps*||C|| ABSOLUTE
        # error, so a structurally-null direction (EK1's zero
        # measurement noise makes every backward smoothing kernel
        # exactly rank-deficient; f32 stores it as zero + rounding) can
        # come back just above the relative screen: on the Lorenz-4k
        # bench config 57 of ~12k borderline directions flipped live,
        # each dumping ~log(tol) ~= -11.5 into the logdet sum — the
        # entire 3.8e-3 fused-daltonng bias of the round-4 audit
        # (VERDICT r4 #2).  lam_min = det/(lam_mid*lam_hi) recovers the
        # small eigenvalue to the relative accuracy of det itself, and
        # ``det > tol * (sum of |cofactor-expansion terms|)`` is a
        # direct significance test of that computation: the direction is
        # LIVE iff the determinant is resolvable above its own rounding
        # noise.  Applied only where the mid eigenvalue is itself live
        # (rank >= 2); rank-<=1 matrices keep the generic screen.
        d = dense
        t0 = d[..., 0, 0] * (d[..., 1, 1] * d[..., 2, 2]
                             - d[..., 1, 2] * d[..., 2, 1])
        t1 = d[..., 0, 1] * (d[..., 1, 0] * d[..., 2, 2]
                             - d[..., 1, 2] * d[..., 2, 0])
        t2 = d[..., 0, 2] * (d[..., 1, 0] * d[..., 2, 1]
                             - d[..., 1, 1] * d[..., 2, 0])
        det = t0 - t1 + t2
        noise = (jnp.abs(d[..., 0, 0] * d[..., 1, 1] * d[..., 2, 2])
                 + jnp.abs(d[..., 0, 0] * d[..., 1, 2] * d[..., 2, 1])
                 + jnp.abs(d[..., 0, 1] * d[..., 1, 0] * d[..., 2, 2])
                 + jnp.abs(d[..., 0, 1] * d[..., 1, 2] * d[..., 2, 0])
                 + jnp.abs(d[..., 0, 2] * d[..., 1, 0] * d[..., 2, 1])
                 + jnp.abs(d[..., 0, 2] * d[..., 1, 1] * d[..., 2, 0]))
        lam_mid, lam_hi = w[..., 1], w[..., 2]
        prod = lam_mid * lam_hi
        rank2 = lam_mid > tol * wmax[..., 0]
        lam_min_ref = det / jnp.where(prod != 0, prod, 1.0)
        lam_min = jnp.where(rank2, lam_min_ref, w[..., 0])
        # live iff BOTH (a) det resolves above its own rounding noise
        # and (b) the refined eigenvalue clears the relative screen the
        # f64 computation applies — (a) alone still kept ~40 structural
        # nulls whose det is filter-noise (resolvable, but noise), (b)
        # alone trusts a possibly-inflated ratio; the conjunction
        # empirically reproduces the f64 keep pattern (exactly one
        # structural null dropped per step/block) on the bench config
        keep_min = jnp.where(
            rank2,
            (det > tol * noise) & (lam_min_ref > tol * wmax[..., 0]),
            keep[..., 0])
        w = jnp.concatenate([lam_min[..., None], w[..., 1:]], axis=-1)
        keep = jnp.concatenate([keep_min[..., None], keep[..., 1:]],
                               axis=-1)
    return w, v, keep


def _unpack_dense(C, q):
    pairs, _ = _tri_idx(q)
    return _unpack_tri(jnp.moveaxis(C, 1, -1), q, pairs)


@functools.partial(jax.custom_jvp, nondiff_argnums=(0,))
def _logdet_packed_q(q, C):
    """Masked log-determinant + dimension count of packed covariances:
    returns ``(sum_kept log w, n_kept)`` with shapes (T, nb, B).

    The derivative is supplied analytically as ``tr(C⁺ dC)`` over the
    kept spectrum (constant-rank semantics): the eigendecomposition's own
    JVP divides by eigenvalue gaps and NaNs on the (near-)degenerate
    spectra these smoothing covariances always carry."""
    w, _, keep = _masked_eigh(C, q)
    safe_w = jnp.where(keep, w, 1.0)
    return (jnp.sum(jnp.where(keep, jnp.log(safe_w), 0.0), axis=-1),
            jnp.sum(keep, axis=-1).astype(w.dtype))


@_logdet_packed_q.defjvp
def _logdet_packed_q_jvp(q, primals, tangents):
    (C,), (dC,) = primals, tangents
    w, v, keep = _masked_eigh(C, q)
    safe_w = jnp.where(keep, w, 1.0)
    ld = jnp.sum(jnp.where(keep, jnp.log(safe_w), 0.0), axis=-1)
    k = jnp.sum(keep, axis=-1).astype(w.dtype)
    # broadcast-sum Mdiag (see _logpdf_packed_q_jvp)
    dCd = _unpack_dense(dC, q)
    dCv = jnp.sum(dCd[..., :, :, None] * v[..., None, :, :], axis=-2)
    Mdiag = jnp.sum(v * dCv, axis=-2)
    dld = jnp.sum(jnp.where(keep, Mdiag / safe_w, 0.0), axis=-1)
    return (ld, k), (dld, jnp.zeros_like(k))


def _logdet_packed(C, q):
    return _logdet_packed_q(q, C)


@functools.partial(jax.custom_jvp, nondiff_argnums=(0,))
def _logpdf_packed_q(q, x, mean, C):
    """Batched eigen-masked MVN logpdf (pseudo-inverse quadratic form)
    with packed covariance: ``x``/``mean`` (T, q, nb, B),
    ``C`` (T, n_tri, nb, B) -> (T, nb, B).  Analytic masked-pseudo-inverse
    JVP (see `_logdet_packed_q` / `utils.multivariate_normal_logpdf`)."""
    val, _ = _logpdf_packed_pieces(q, x, mean, C)
    return val


def _logpdf_packed_pieces(q, x, mean, C):
    w, v, keep = _masked_eigh(C, q)
    z = jnp.moveaxis(x - mean, 1, -1)                      # (T, nb, B, q)
    # broadcast-sum, NOT einsum: batched q=3 dot_generals are tiny
    # padded contractions
    zv = jnp.sum(z[..., :, None] * v, axis=-2)
    safe_w = jnp.where(keep, w, 1.0)
    quad = jnp.sum(jnp.where(keep, zv * zv / safe_w, 0.0), axis=-1)
    logdet = jnp.sum(jnp.where(keep, jnp.log(safe_w), 0.0), axis=-1)
    k = jnp.sum(keep, axis=-1).astype(w.dtype)
    val = -0.5 * (quad + logdet + k * _LOG2PI)
    return val, (w, v, keep, safe_w, zv)


@_logpdf_packed_q.defjvp
def _logpdf_packed_q_jvp(q, primals, tangents):
    (x, mean, C), (dx, dmean, dC) = primals, tangents
    val, (w, v, keep, safe_w, zv) = _logpdf_packed_pieces(q, x, mean, C)
    alpha = jnp.where(keep, zv / safe_w, 0.0)
    dz = jnp.moveaxis(dx - dmean, 1, -1)
    # broadcast-sum forms throughout (see _logpdf_packed_pieces): the
    # original einsum contractions were the daltonng pipeline bottleneck
    dzv = jnp.sum(dz[..., :, None] * v, axis=-2)
    term1 = 2.0 * jnp.sum(alpha * dzv, axis=-1)
    dCd = _unpack_dense(dC, q)
    # va_j = sum_i v_ji alpha_i;  alpha' (v' dC v) alpha = va' dC va
    va = jnp.sum(v * alpha[..., None, :], axis=-1)
    term2 = -jnp.sum(va[..., :, None] * dCd * va[..., None, :],
                     axis=(-2, -1))
    # Mdiag_i = (v' dC v)_ii via dCv_ji = sum_l dC_jl v_li
    dCv = jnp.sum(dCd[..., :, :, None] * v[..., None, :, :], axis=-2)
    Mdiag = jnp.sum(v * dCv, axis=-2)
    term3 = jnp.sum(jnp.where(keep, Mdiag / safe_w, 0.0), axis=-1)
    return val, -0.5 * (term1 + term2 + term3)


def _logpdf_packed(x, mean, C, q):
    return _logpdf_packed_q(q, x, mean, C)


def daltonng_fused_batch(thetas, ode_weight, ode_inits,
                         t_min, t_max, n_steps,
                         prior_pars,
                         obs_data, obs_times, obs_comp_flat, obs_dims,
                         ode_flat, jac_flat=None, kalman_type="standard",
                         _return_parts=False):
    r"""
    Lane-batched fused non-Gaussian DALTON log-likelihood
    ``logy_x + logx_z - logx_yhat`` — ``n_lane`` evaluations per pipeline.

    Args:
        obs_comp_flat (Callable): Elementwise per-component observation
            loglik contribution
            ``obs_comp_flat(y_cols, x_col, j, th, iobs) -> (n_block, B)``
            — elementwise in the column values, evaluated at state
            component ``j`` (0-th derivative = ``j = 0``); the total
            loglik of observation ``i`` must equal
            :math:`\sum_{b} \sum_{j \in \text{obs\_dims}}`
            of these contributions.  The Laplace gradient and Hessian are
            derived from it by forward-mode autodiff (the Hessian is
            assumed diagonal — component-independent observations — and
            strictly negative on observed components).
        obs_dims (tuple): State-component indices the loglik depends on
            (e.g. ``(0,)`` for position-only observations).
        (other args as
        :func:`rodeo_tpu.ops.pallas_dalton.dalton_fused_batch`, minus the
        Gaussian ``obs_weight``/``obs_var``)

    Returns:
        (ndarray(n_lane,)): Log-likelihood per lane.  Parity target:
        ``rodeo_tpu.inference.dalton.daltonng`` == upstream
        ``dalton.py:851-949``.
    """
    from rodeo_tpu.ops.pallas_kalman import (resolve_kalman_type,
                                             normalize_prior_pars)
    kalman_type = resolve_kalman_type(kalman_type)
    prior_pars = normalize_prior_pars(kalman_type, prior_pars)
    n_lane = thetas.shape[0]
    n_block, n_bmeas, q = ode_weight.shape
    if n_bmeas != 1:
        raise NotImplementedError(
            "daltonng_fused_batch requires n_bmeas == 1")
    with jax.default_matmul_precision("highest"):
        return _daltonng_fused_batch_impl(
            thetas, ode_weight, ode_inits, t_min, t_max, n_steps,
            prior_pars, obs_data, obs_times, obs_comp_flat, obs_dims,
            ode_flat, jac_flat, _return_parts=_return_parts)


def _daltonng_fused_batch_impl(thetas, ode_weight, ode_inits,
                               t_min, t_max, n_steps, prior_pars,
                               obs_data, obs_times, obs_comp_flat,
                               obs_dims, ode_flat, jac_flat,
                               _return_parts=False):
    # highest-precision matmuls: the logpdf einsums run on Taylor-scaled
    # quantities of magnitude ~1e6, where a reduced-precision (bf16 or
    # TF32) matmul pass injects ~1e-3 relative noise
    n_lane = thetas.shape[0]
    n_block, n_bmeas, q = ode_weight.shape
    pairs, _ = _tri_idx(q)
    n_tri = len(pairs)
    dt = (t_max - t_min) / n_steps
    t_vec = taylor_scale(dt, q, dtype=jnp.float32)
    Qs, Rs = scale_prior(prior_pars, t_vec)
    q_const = _static_scaled_qconst(prior_pars[0], dt, q)
    if q_const is None:
        raise NotImplementedError(
            "daltonng_fused_batch requires a block-constant transition "
            "available at trace time (a concrete block-constant "
            "prior, e.g. ibm_init, built/cast OUTSIDE jit — an "
            "astype/scale applied inside a jitted closure turns it "
            "into a tracer)")
    W_s = (ode_weight * t_vec[None, None, :])[:, 0, :]
    x0_lanes = jnp.transpose(
        (ode_inits / t_vec).astype(jnp.float32), (2, 1, 0))
    tgrid = t_min + (t_max - t_min) * (jnp.arange(n_steps) + 1) / n_steps
    theta_lanes = jnp.transpose(thetas).astype(jnp.float32)
    mode = "kramer" if jac_flat is not None else "rodeo"

    # observation grid (obs at t=0 enters only through logy_x, as in the
    # reference: the exact init is never pseudo-updated)
    n_obs = obs_data.shape[0]
    n_ydim = obs_data.shape[-1] if obs_data.ndim == 3 else 1
    y_flat = obs_data.reshape(n_obs, n_block, n_ydim).astype(jnp.float32)
    sim_times = jnp.linspace(t_min, t_max, n_steps + 1)
    obs_ind = jnp.searchsorted(sim_times, obs_times)
    y_grid = jnp.zeros((n_steps + 1, n_block, n_ydim), jnp.float32)
    y_grid = y_grid.at[obs_ind].set(y_flat)
    iobs_grid = jnp.zeros((n_steps + 1, 1), jnp.float32)
    iobs_grid = iobs_grid.at[obs_ind, 0].set(
        jnp.arange(n_obs, dtype=jnp.float32))
    mask_grid = jnp.zeros((n_steps + 1, 1), jnp.float32)
    mask_grid = mask_grid.at[obs_ind, 0].set(1.0)
    mask_grid = mask_grid.at[0, 0].set(0.0)
    y_k = jnp.transpose(y_grid[1:], (0, 2, 1))[..., None]  # (T, ydim, nb, 1)

    # --- filter 1: Laplace-linearized (conditions on Z and pseudo-Y) ----
    mf, pf, mp, pp = _filter_nn_batch_tan(
        ode_flat, jac_flat, obs_comp_flat, tuple(obs_dims), mode, 0,
        n_steps, Qs, Rs, W_s, x0_lanes, theta_lanes, tgrid, t_vec,
        y_k, iobs_grid[1:], mask_grid[1:], q_const)

    # prepend the exact init row so indices match the XLA layout
    m0 = x0_lanes[None]                                   # (1, q, nb, B)
    p0 = jnp.zeros((1, n_tri, n_block, n_lane), jnp.float32)
    mf_full = jnp.concatenate([m0, mf])                   # rows 0..N
    pf_full = jnp.concatenate([p0, pf])
    mp_full = jnp.concatenate([m0, mp])
    pp_full = jnp.concatenate([p0, pp])

    # backward-kernel parameters (G, b, C) for n = 1..N-1
    G_k, b_k, C = _cond_params_cols(q, n_tri, q_const, Rs,
                                    mf_full[1:], pf_full[1:],
                                    mp_full[1:], pp_full[1:])

    # smoothed means: rows 1..N-1 via the shared backward recursion
    means = _suffix_means(G_k, b_k, C, mf_full[n_steps],
                          pf_full[n_steps])
    mean_path = jnp.concatenate([m0, means, mf_full[n_steps][None]])

    # logx_yhat: quadratic form vanishes at the smoothed mean ->
    # (masked) log-determinant sums only (terminal + backward kernels)
    ld_C, k_C = _logdet_packed(C, q)
    ld_N, k_N = _logdet_packed(pf_full[n_steps][None], q)
    logx_yhat = -0.5 * (
        jnp.sum(ld_C, axis=(0, 1)) + jnp.sum(ld_N, axis=(0, 1))
        + (jnp.sum(k_C, axis=(0, 1)) + jnp.sum(k_N, axis=(0, 1)))
        * _LOG2PI)

    # logy_x: user loglik at the smoothed means, original coordinates
    tv_col = t_vec.astype(jnp.float32)[:, None, None]       # (q, 1, 1)
    mean_orig = mean_path * tv_col                          # (N+1,q,nb,B)
    logy_x = jnp.zeros((n_lane,), jnp.float32)
    for j in obs_dims:
        # (n_obs, nb, B) contributions at the observed rows
        x_obs = mean_orig[obs_ind, j]                       # (n_obs,nb,B)
        y_cols = [y_flat[:, :, d, None] for d in range(n_ydim)]
        contrib = obs_comp_flat(
            y_cols, x_obs, j, theta_lanes,
            jnp.arange(n_obs, dtype=jnp.float32)[:, None, None])
        logy_x = logy_x + jnp.sum(contrib, axis=(0, 1))

    # --- filter 2: plain ODE filter (marginal p(Z)) ---------------------
    # gains emitted by the filter step (entry 0 conditions onto the Dirac
    # init — not needed); final filtered state seeds logx_zN
    Az_k, bz_full, Cz_full, mz_last, pz_last = fused_filter_batch(
        ode_flat, jac_flat, n_steps, Qs, Rs, W_s, x0_lanes,
        theta_lanes, tgrid, t_vec,
        raw_q_const=q_const, mode=mode, emit="gains")
    Gz_k, bz_k, Cz = Az_k[1:], bz_full[1:], Cz_full[1:]

    # logx_z at the smoothed-mean path
    logx_zN = jnp.sum(_logpdf_packed(
        mean_path[n_steps][None], mz_last[None],
        pz_last[None], q), axis=(0, 1))
    # mean_sim_i = b_i + sum_j Gz[i,j] path_j — elementwise column sums
    # (einsum on these layouts lowers to costly transposes, and a default
    # f32 dot may run at reduced precision)
    path_n1 = mean_path[2:n_steps + 1]                # (T-1, q, nb, B)
    mean_sim = bz_k + jnp.stack(
        [sum(Gz_k[:, i * q + j] * path_n1[:, j] for j in range(q))
         for i in range(q)], axis=1)
    logx_z = logx_zN + jnp.sum(_logpdf_packed(
        mean_path[1:n_steps], mean_sim, Cz, q), axis=(0, 1))

    if _return_parts:
        # diagnostic hook: the three assembly components (+ the smoothed
        # mean path and covariance inputs) so accuracy work can localize
        # a bias per-term
        return logy_x + logx_z - logx_yhat, {
            "logy_x": logy_x, "logx_z": logx_z, "logx_yhat": logx_yhat,
            "mean_path": mean_path, "C": C, "Cz": Cz,
            "pf_N": pf_full[n_steps], "ld_C": ld_C, "k_C": k_C}
    return logy_x + logx_z - logx_yhat


def daltonng_fused_batch_grad(thetas, ode_weight, ode_inits,
                              t_min, t_max, n_steps,
                              prior_pars,
                              obs_data, obs_times, obs_comp_flat, obs_dims,
                              ode_flat, jac_flat=None,
                              kalman_type="standard"):
    r"""
    Lane-batched fused non-Gaussian DALTON log-likelihood AND its
    theta-gradient via forward-mode tangent augmentation:

    * the Laplace filter carries tangent state (`jax.jvp` of the pure
      step — the tangent of the Laplace linearization uses THIRD
      derivatives of the user loglik, all by nested forward-mode);
    * the plain filter rides the fenrir tangent filter;
    * the smoothed-mean recursion rides the shared tangent mean
      recursion;
    * the pure XLA stages (gains, masked log-densities) are differentiated
      by plain `jax.jvp` — the masked eigen log-densities carry analytic
      constant-rank JVPs (`_logdet_packed_q`/`_logpdf_packed_q`).

    ``ode_inits`` must not depend on theta (tangents seeded zero).

    Args as :func:`daltonng_fused_batch`.

    Returns:
        (tuple): ``loglik (n_lane,)``, ``grad (n_lane, n_theta)``.
    """
    from rodeo_tpu.ops.pallas_kalman import resolve_kalman_type
    from rodeo_tpu.ops.pallas_kalman import (resolve_kalman_type,
                                             normalize_prior_pars)
    kalman_type = resolve_kalman_type(kalman_type)
    prior_pars = normalize_prior_pars(kalman_type, prior_pars)
    from rodeo_tpu.ops.pallas_fenrir import fused_filter_batch_tan
    from rodeo_tpu.ops.pallas_kalman import (
        smoother_mean_recursion_batch_tan)

    n_lane, n_theta = thetas.shape
    n_tan = n_theta
    n_aug = 1 + n_tan
    n_block, n_bmeas, q = ode_weight.shape
    if n_bmeas != 1:
        raise NotImplementedError(
            "daltonng_fused_batch_grad requires n_bmeas == 1")
    pairs, _ = _tri_idx(q)
    n_tri = len(pairs)
    dt = (t_max - t_min) / n_steps
    t_vec = taylor_scale(dt, q, dtype=jnp.float32)
    Qs, Rs = scale_prior(prior_pars, t_vec)
    q_const = _static_scaled_qconst(prior_pars[0], dt, q)
    if q_const is None:
        raise NotImplementedError(
            "daltonng_fused_batch_grad requires a block-constant "
            "transition available at trace time")
    W_s = (ode_weight * t_vec[None, None, :])[:, 0, :]
    x0_lanes = jnp.transpose(
        (ode_inits / t_vec).astype(jnp.float32), (2, 1, 0))
    tgrid = t_min + (t_max - t_min) * (jnp.arange(n_steps) + 1) / n_steps
    theta_lanes = jnp.transpose(thetas).astype(jnp.float32)
    mode = "kramer" if jac_flat is not None else "rodeo"

    n_obs = obs_data.shape[0]
    n_ydim = obs_data.shape[-1] if obs_data.ndim == 3 else 1
    y_flat = obs_data.reshape(n_obs, n_block, n_ydim).astype(jnp.float32)
    sim_times = jnp.linspace(t_min, t_max, n_steps + 1)
    obs_ind = jnp.searchsorted(sim_times, obs_times)
    y_grid = jnp.zeros((n_steps + 1, n_block, n_ydim), jnp.float32)
    y_grid = y_grid.at[obs_ind].set(y_flat)
    iobs_grid = jnp.zeros((n_steps + 1, 1), jnp.float32)
    iobs_grid = iobs_grid.at[obs_ind, 0].set(
        jnp.arange(n_obs, dtype=jnp.float32))
    mask_grid = jnp.zeros((n_steps + 1, 1), jnp.float32)
    mask_grid = mask_grid.at[obs_ind, 0].set(1.0)
    mask_grid = mask_grid.at[0, 0].set(0.0)
    y_k = jnp.transpose(y_grid[1:], (0, 2, 1))[..., None]

    dths = []
    for k in range(n_tan):
        rows = [jnp.ones((1, n_lane), jnp.float32) if i == k
                else jnp.zeros((1, n_lane), jnp.float32)
                for i in range(n_theta)]
        dths.append(jnp.concatenate(rows, axis=0))

    with jax.default_matmul_precision("highest"):
        # --- tangent-augmented filters ----------------------------------
        mf_a, pf_a, mp_a, pp_a = _filter_nn_batch_tan(
            ode_flat, jac_flat, obs_comp_flat, tuple(obs_dims), mode,
            n_tan, n_steps, Qs, Rs, W_s, x0_lanes, theta_lanes, tgrid,
            t_vec, y_k, iobs_grid[1:], mask_grid[1:], q_const)
        mfz_a, pfz_a, mpz_a, ppz_a = fused_filter_batch_tan(
            ode_flat, jac_flat, mode, n_tan, n_steps, Qs, Rs, W_s,
            x0_lanes, theta_lanes, tgrid, t_vec, q_const)

        m0 = x0_lanes[None]
        p0 = jnp.zeros((1, n_tri, n_block, n_lane), jnp.float32)

        def sl(a, d, width):
            return a[:, d * width:(d + 1) * width]

        # --- stage 1 (XLA, jvp per tangent): recursion inputs -----------
        def pre(mf, pf, mp, pp):
            mf_full = jnp.concatenate([m0, mf])
            pf_full = jnp.concatenate([p0, pf])
            mp_full = jnp.concatenate([m0, mp])
            pp_full = jnp.concatenate([p0, pp])
            G_k, b_k, C = _cond_params_cols(q, n_tri, q_const, Rs,
                                            mf_full[1:], pf_full[1:],
                                            mp_full[1:], pp_full[1:])
            return G_k, b_k, mf_full[n_steps]

        prims1 = (sl(mf_a, 0, q), sl(pf_a, 0, n_tri),
                  sl(mp_a, 0, q), sl(pp_a, 0, n_tri))
        outs1 = [pre(*prims1)]
        for k in range(n_tan):
            # init-row tangents are zero automatically: m0/p0 are closed
            # over in `pre` (theta-independent x0)
            tans1 = (sl(mf_a, 1 + k, q), sl(pf_a, 1 + k, n_tri),
                     sl(mp_a, 1 + k, q), sl(pp_a, 1 + k, n_tri))
            _, tan_out = jax.jvp(pre, prims1, tans1)
            outs1.append(tan_out)
        G_aug = jnp.concatenate([o[0] for o in outs1], axis=1)
        b_aug = jnp.concatenate([o[1] for o in outs1], axis=1)
        mN_aug = jnp.concatenate([o[2] for o in outs1], axis=0)

        # --- tangent mean recursion -------------------------------------
        means_aug = smoother_mean_recursion_batch_tan(
            b_aug, G_aug, mN_aug, n_tan)

        # --- stage 2 (XLA, jvp per tangent): log-densities --------------
        def post(th, mf, pf, mp, pp, mfz, pfz, mpz, ppz, means):
            mf_full = jnp.concatenate([m0, mf])
            pf_full = jnp.concatenate([p0, pf])
            mp_full = jnp.concatenate([m0, mp])
            pp_full = jnp.concatenate([p0, pp])
            _, _, C = _cond_params_cols(q, n_tri, q_const, Rs,
                                        mf_full[1:], pf_full[1:],
                                        mp_full[1:], pp_full[1:])
            mean_path = jnp.concatenate(
                [m0, means, mf_full[n_steps][None]])
            ld_C, k_C = _logdet_packed(C, q)
            ld_N, k_N = _logdet_packed(pf_full[n_steps][None], q)
            logx_yhat = -0.5 * (
                jnp.sum(ld_C, axis=(0, 1)) + jnp.sum(ld_N, axis=(0, 1))
                + (jnp.sum(k_C, axis=(0, 1)) + jnp.sum(k_N, axis=(0, 1)))
                * _LOG2PI)
            tv_col = t_vec.astype(jnp.float32)[:, None, None]
            mean_orig = mean_path * tv_col
            logy_x = jnp.zeros((n_lane,), jnp.float32)
            for j in obs_dims:
                x_obs = mean_orig[obs_ind, j]
                y_cols = [y_flat[:, :, d, None] for d in range(n_ydim)]
                contrib = obs_comp_flat(
                    y_cols, x_obs, j, th,
                    jnp.arange(n_obs, dtype=jnp.float32)[:, None, None])
                logy_x = logy_x + jnp.sum(contrib, axis=(0, 1))
            mfz_full = jnp.concatenate([m0, mfz])
            pfz_full = jnp.concatenate([p0, pfz])
            mpz_full = jnp.concatenate([m0, mpz])
            ppz_full = jnp.concatenate([p0, ppz])
            Gz_k, bz_k, Cz = _cond_params_cols(q, n_tri, q_const, Rs,
                                               mfz_full[1:], pfz_full[1:],
                                               mpz_full[1:], ppz_full[1:])
            logx_zN = jnp.sum(_logpdf_packed(
                mean_path[n_steps][None], mfz_full[n_steps][None],
                pfz_full[n_steps][None], q), axis=(0, 1))
            path_n1 = mean_path[2:n_steps + 1]
            mean_sim = bz_k + jnp.stack(
                [sum(Gz_k[:, i * q + j] * path_n1[:, j] for j in range(q))
                 for i in range(q)], axis=1)
            logx_z = logx_zN + jnp.sum(_logpdf_packed(
                mean_path[1:n_steps], mean_sim, Cz, q), axis=(0, 1))
            return logy_x + logx_z - logx_yhat

        prims2 = (theta_lanes,
                  sl(mf_a, 0, q), sl(pf_a, 0, n_tri),
                  sl(mp_a, 0, q), sl(pp_a, 0, n_tri),
                  sl(mfz_a, 0, q), sl(pfz_a, 0, n_tri),
                  sl(mpz_a, 0, q), sl(ppz_a, 0, n_tri),
                  sl(means_aug, 0, q))
        ll = post(*prims2)
        grads = []
        for k in range(n_tan):
            tans2 = (dths[k],
                     sl(mf_a, 1 + k, q), sl(pf_a, 1 + k, n_tri),
                     sl(mp_a, 1 + k, q), sl(pp_a, 1 + k, n_tri),
                     sl(mfz_a, 1 + k, q), sl(pfz_a, 1 + k, n_tri),
                     sl(mpz_a, 1 + k, q), sl(ppz_a, 1 + k, n_tri),
                     sl(means_aug, 1 + k, q))
            _, dll = jax.jvp(post, prims2, tans2)
            grads.append(dll)
        return ll, jnp.stack(grads, axis=-1)
