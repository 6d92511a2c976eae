r"""
Fused lane-batched filter and smoother for the probabilistic ODE solver.

The sequential time loop is the latency wall of the solver: under plain
XLA each of the ``n_steps`` iterations re-runs a graph of tiny
:math:`q \times q` ops.  Here one solver step is a **pure step function**
on column tiles, and a driver runs it over time:

* :func:`rodeo_tpu.ops.scan.scan_steps` runs it under ``lax.scan`` on the
  full ``(n_block, n_lane)`` tiles — the CPU path and the reference;
* on a GPU, the forward filter and the backward smoother run as
  Pallas-through-Triton kernels (:mod:`rodeo_tpu.ops.triton_kalman`) that
  keep the whole time loop inside one program, the state in registers.
  :func:`rodeo_tpu.ops.scan.kernel_route` makes that choice.

Design notes:

* The per-block state is kept as Python lists of column tiles, so the
  per-step matrix algebra unrolls at trace time into scalar-coefficient
  FMAs on columns (``_sym_quadform``, ``_sym_inv``, ``_chol_cols``).
* Covariances are symmetric: only the upper triangle is carried
  (``q(q+1)/2`` columns).
* The ODE right-hand side and its block-diagonal Jacobian enter as
  "flat" callables (see :mod:`rodeo_tpu.models` ``*_flat`` variants):
  ``ode_flat(x_cols, th, t)`` takes ``q`` columns of shape
  ``(n_block, n_lane)`` and per-lane parameters ``(n_theta, n_lane)``
  and returns ``(n_block, n_lane)``.  The operations it may use (row
  slices and concatenation, row sums, elementwise math; no matmuls and
  nothing across lanes) are listed in :mod:`rodeo_tpu.ops.flat_rows`,
  and every driver checks them at trace time, so a callable that runs
  on the CPU also runs in the GPU kernels.
* The step functions expect **Taylor-preconditioned** inputs
  (:mod:`rodeo_tpu.ops.precond`): float32 needs the O(1)-conditioned
  prior, and the Joseph-form update is used throughout.

The public entry points :func:`solve_mv_fused` (one solve) and
:func:`solve_mv_fused_batch` (``n_lane`` solves) match the ``solve_mv``
contract for supported configurations (``n_bmeas == 1``, standard form,
EK1/zero-order interrogations, ``q <= 5``).
"""
import jax
import jax.numpy as jnp

from rodeo_tpu.ops.flat_rows import flat_call
from rodeo_tpu.ops.precond import taylor_scale, scale_prior
from rodeo_tpu.ops.scan import kernel_route, scan, scan_steps

__all__ = ["fused_filter_batch", "smoother_recursion_batch",
           "solve_mv_fused", "solve_mv_fused_batch",
           "solve_mv_fused_stationary", "basic_fused_batch",
           "solve_mv_fused_batch_grad", "basic_fused_batch_grad",
           "jvp_jac_flat", "chol_packed", "unpack_chol",
           "resolve_kalman_type"]


def _tri_idx(q):
    """Upper-triangle (i, j) pairs and a dense->packed index map."""
    pairs = [(i, j) for i in range(q) for j in range(i, q)]
    where = {}
    for k, (i, j) in enumerate(pairs):
        where[(i, j)] = k
        where[(j, i)] = k
    return pairs, where


def _coef_mul(a, col):
    """Multiply a column by a coefficient that may be a trace-time float
    (0.0 -> dropped, 1.0 -> identity) or a (n_block, 1) column."""
    if isinstance(a, float):
        if a == 0.0:
            return None
        if a == 1.0:
            return col
    return a * col


def _acc(acc, term):
    if term is None:
        return acc
    return term if acc is None else acc + term


def _sym_quadform(q, A, P_cols, where):
    r"""
    Columns of the upper triangle of ``A P A'`` where ``A`` is a
    list-of-lists of coefficient columns and ``P_cols`` is packed-symmetric.
    Unrolled at trace time into FMAs on ``(n_block, 1)`` columns.
    """
    T = [[None] * q for _ in range(q)]
    for i in range(q):
        for k in range(q):
            acc = None
            for j in range(q):
                acc = _acc(acc, _coef_mul(A[i][j], P_cols[where[(j, k)]]))
            T[i][k] = acc
    out = []
    for i in range(q):
        for l in range(i, q):
            acc = None
            for k in range(q):
                if T[i][k] is None:
                    continue
                acc = _acc(acc, _coef_mul(A[l][k], T[i][k]))
            out.append(acc)
    return out


def _matvec(q, A, v_cols):
    """Columns of ``A v`` with the same coefficient conventions."""
    out = []
    for i in range(q):
        acc = None
        for j in range(q):
            acc = _acc(acc, _coef_mul(A[i][j], v_cols[j]))
        out.append(acc)
    return out




def _sym_inv(q, p_cols):
    """Closed-form inverse of a packed-symmetric matrix in column
    arithmetic, scale-normalized against float32 determinant overflow.
    Direct cofactor forms for q <= 3; q = 4, 5 via one level of 2+(q-2)
    block partitioning (Schur complement), recursing into the small
    forms — every operation stays an elementwise FMA on columns, so the
    whole inverse unrolls inside GPU kernels and batched XLA alike."""
    if q == 1:
        return [1.0 / p_cols[0]]
    if q == 2:
        a, b, d = p_cols
        inv_det = 1.0 / (a * d - b * b)
        return [d * inv_det, -b * inv_det, a * inv_det]
    if q == 3:
        a, b, c, d, e, f = p_cols  # [00,01,02,11,12,22]
        s = jnp.maximum(jnp.abs(a), jnp.maximum(jnp.abs(d), jnp.abs(f)))
        rs = 1.0 / jnp.maximum(s, 1e-30)
        a, b, c, d, e, f = a * rs, b * rs, c * rs, d * rs, e * rs, f * rs
        co00 = d * f - e * e
        co01 = c * e - b * f
        co02 = b * e - c * d
        co11 = a * f - c * c
        co12 = b * c - a * e
        co22 = a * d - b * b
        det = a * co00 + b * co01 + c * co02
        inv_det = rs / det
        return [co00 * inv_det, co01 * inv_det, co02 * inv_det,
                co11 * inv_det, co12 * inv_det, co22 * inv_det]
    if q in (4, 5):
        pairs, where = _tri_idx(q)
        diag = [p_cols[where[(i, i)]] for i in range(q)]
        s = diag[0]
        for dcol in diag[1:]:
            s = jnp.maximum(jnp.abs(s), jnp.abs(dcol))
        rs = 1.0 / jnp.maximum(s, 1e-30)
        pc = [col * rs for col in p_cols]
        k, m = 2, q - 2
        # M = [[A, B], [B', D]] with A (k,k), B (k,m), D (m,m)
        Ainv = _sym_inv(k, [pc[where[(0, 0)]], pc[where[(0, 1)]],
                            pc[where[(1, 1)]]])
        _, whA = _tri_idx(k)
        B = [[pc[where[(i, k + j)]] for j in range(m)] for i in range(k)]
        # C = A^{-1} B
        C = [[None] * m for _ in range(k)]
        for i in range(k):
            for j in range(m):
                acc = None
                for l in range(k):
                    acc = _acc(acc, Ainv[whA[(i, l)]] * B[l][j])
                C[i][j] = acc
        # Schur complement S = D - B' C (packed symmetric)
        _, whS = _tri_idx(m)
        S_cols = []
        for i in range(m):
            for j in range(i, m):
                acc = pc[where[(k + i, k + j)]]
                for l in range(k):
                    acc = acc - B[l][i] * C[l][j]
                S_cols.append(acc)
        Sinv = _sym_inv(m, S_cols)
        # inverse blocks: UL = A^{-1} + C S^{-1} C', UR = -C S^{-1},
        # LR = S^{-1}
        UR = [[None] * m for _ in range(k)]
        for i in range(k):
            for j in range(m):
                acc = None
                for l in range(m):
                    acc = _acc(acc, C[i][l] * Sinv[whS[(l, j)]])
                UR[i][j] = -acc
        out = []
        for i in range(q):
            for j in range(i, q):
                if j < k:                       # UL block
                    acc = Ainv[whA[(i, j)]]
                    for l in range(m):
                        acc = acc - UR[i][l] * C[j][l]
                    out.append(acc * rs)
                elif i < k:                     # UR block
                    out.append(UR[i][j - k] * rs)
                else:                           # LR block
                    out.append(Sinv[whS[(i - k, j - k)]] * rs)
        return out
    raise NotImplementedError("fused solvers support q <= 5")


def _chol_cols(q, p_cols, where, floor=1e-12):
    """Closed-form Cholesky of a packed-symmetric matrix in column layout
    (list of ``n_tri`` like-shaped arrays; returns lower-triangular
    ``L[i][j]``, j <= i, unrolled at trace time).

    Float32-stable: normalized to correlation form (unit diagonal),
    factored with a *relative* pivot floor, rows rescaled.  Without this,
    near-unit correlations make the Schur complements cancel
    catastrophically in f32 (pivot -> ~0, next column -> ~1e20); a
    floored pivot corresponds to ~1e-6 relative noise in a genuinely
    degenerate direction.
    """
    tiny = jnp.asarray(1e-38, p_cols[0].dtype)
    d = [jnp.sqrt(jnp.maximum(p_cols[where[(i, i)]], tiny))
         for i in range(q)]
    rd = [1.0 / di for di in d]
    L = [[None] * (i + 1) for i in range(q)]
    ok = [None] * q     # pivot genuinely positive (not floored)?
    for i in range(q):
        for j in range(i + 1):
            s = p_cols[where[(i, j)]] * (rd[i] * rd[j])
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                ok[i] = s > floor
                L[i][i] = jnp.sqrt(jnp.maximum(s, floor))
            else:
                # a floored pivot marks a (numerically) null direction:
                # the rank-deficient factor has ZEROS below it — dividing
                # cancellation noise by the floored pivot would otherwise
                # blow the remaining columns up by ~1/floor
                L[i][j] = jnp.where(ok[j], s / L[j][j],
                                    jnp.zeros_like(s))
    return [[L[i][j] * d[i] for j in range(i + 1)] for i in range(q)]


def _chol_matvec(q, L, eps_cols):
    """Columns of ``L @ eps`` for a lower-triangular column factor."""
    return [sum(L[i][j] * eps_cols[j] for j in range(i + 1))
            for i in range(q)]


def jvp_jac_flat(ode_flat, n_block, q):
    r"""
    Build a block-diagonal Jacobian callable from ``ode_flat`` alone, via
    one ``jax.jvp`` per (block, state-column) pair with single-row seed
    columns (:math:`n_{block} \cdot q` forward-mode tangents, unrolled at
    trace time).  Use when no hand-written ``*_jac_flat`` exists; an
    analytic Jacobian is cheaper.
    """

    def jac_flat(x_cols, th, t):
        def f(cols):
            return ode_flat(cols, th, t)

        row = jnp.ones_like(x_cols[0][0:1])
        zero = jnp.zeros_like(row)
        out_cols = []
        for j in range(q):
            col = []
            for b in range(n_block):
                seeds = [jnp.zeros_like(c) for c in x_cols]
                seeds[j] = jnp.concatenate(
                    [row if bb == b else zero for bb in range(n_block)],
                    axis=0)
                _, tang = jax.jvp(f, (x_cols,), (seeds,))
                col.append(tang[b:b + 1])
            out_cols.append(jnp.concatenate(col, axis=0))
        return out_cols

    return jac_flat


def _const_coefs(prior_weight):
    """If the transition matrix is identical across blocks, return its
    entries as a list-of-lists of Python floats (trace-time constants for
    the step functions); otherwise None."""
    import numpy as np
    try:
        qw = np.asarray(prior_weight)
    except Exception:  # traced values cannot be constants
        return None
    if not np.all(qw == qw[0]):
        return None
    q = qw.shape[-1]
    return [[float(qw[0, i, j]) for j in range(q)] for i in range(q)]


def _static_scaled_qconst(prior_weight_raw, dt, q):
    """Trace-time constants of the Taylor-scaled transition, computed in
    numpy from the *raw* (pre-scaling) prior so it works even when the
    scaling itself is traced under jit.  Returns None if the raw prior is
    a tracer or differs across blocks."""
    import numpy as np
    from scipy.special import gammaln
    try:
        qw = np.asarray(prior_weight_raw, dtype=np.float64)
    except Exception:
        return None
    if not np.all(qw == qw[0]):
        return None
    i = np.arange(q, dtype=np.float64)
    tv = np.sqrt(dt) * dt ** (q - 1.0 - i) / np.exp(gammaln(q - i))
    qs = qw[0] * (tv[None, :] / tv[:, None])
    return [[float(np.float32(qs[i2, j2])) for j2 in range(q)]
            for i2 in range(q)]


def p_cols_at(p_cols, where, i, j):
    return p_cols[where[(i, j)]]



def _pack_tri(mat, pairs):
    """(..., q, q) -> packed upper triangle (..., n_tri)."""
    return jnp.stack([mat[..., i, j] for (i, j) in pairs], axis=-1)


def _unpack_tri(packed, q, pairs):
    """Packed (..., n_tri) -> dense symmetric (..., q, q) (scatter-free)."""
    where = {}
    for k, (i, j) in enumerate(pairs):
        where[(i, j)] = k
        where[(j, i)] = k
    rows = [jnp.stack([packed[..., where[(i, j)]] for j in range(q)],
                      axis=-1) for i in range(q)]
    return jnp.stack(rows, axis=-2)


def resolve_kalman_type(kalman_type):
    r"""
    Normalize/validate the fused entries' ``kalman_type``.

    The fused pipelines propagate covariances in Joseph form —
    :math:`(I-KH)\Sigma(I-KH)' + KVK'`, a sum of congruences of PSD
    matrices — which is PSD-by-construction exactly like the reference's
    square-root (QR) form (upstream ``rodeo/kalmantv/
    square_root.py``); combined with the Taylor preconditioning it covers
    the f32-robustness role that form plays upstream.  The *likelihood
    value* of fenrir/dalton/basic is determined by the propagated
    covariances and is therefore form-independent: both ``"standard"``
    and ``"sqrt"`` ride the same filters (parity vs the f64 square-root
    reference is tested).  Solution entries (``solve_mv_fused*``) honor
    the square-root output contract by returning Cholesky factors of the
    smoothed covariances (same Gram as the reference's QR factors, which
    are only ever defined up to a right orthogonal transform).
    """
    valid = {"standard": "standard", "sqrt": "sqrt",
             "square-root": "sqrt", "square_root": "sqrt"}
    if kalman_type not in valid:
        raise ValueError(
            "kalman_type must be one of 'standard', 'sqrt'/'square-root'; "
            f"got {kalman_type!r}")
    return valid[kalman_type]


def normalize_prior_pars(kalman_type, prior_pars):
    """Covariance-form ``(prior_weight, prior_var)``: the square-root API
    passes variances as factors (:mod:`rodeo_tpu.kalmantv.square_root`
    ``predict`` contract, e.g. ``prior_pars=(W, cholesky(var))``), while
    the fused pipelines propagate covariances — square the factor so the
    sqrt caller's arguments are drop-in.  ``kalman_type`` must already be
    normalized by :func:`resolve_kalman_type`."""
    if kalman_type == "sqrt" and prior_pars is not None:
        w, v = prior_pars
        return (w, v @ jnp.swapaxes(v, -1, -2))
    return prior_pars


def normalize_meas_var(kalman_type, var_meas):
    """Covariance-form Gaussian measurement variance (the square-root API
    passes ``obs_var`` as a factor); see :func:`normalize_prior_pars`."""
    if kalman_type == "sqrt" and var_meas is not None:
        return var_meas @ jnp.swapaxes(var_meas, -1, -2)
    return var_meas


def chol_packed(packed, q, floor=1e-12, axis=-1):
    r"""
    Closed-form lower Cholesky of packed-symmetric covariances, staying in
    the packed layout (no dense ``(q, q)`` materialization: one batched
    elementwise recurrence over the whole array, unrolled at trace time).

    ``packed`` carries the upper-triangle pairs ``(i, j), i <= j`` of
    :func:`_tri_idx` along ``axis``; the returned array has the same shape
    with entry ``k = (i, j)`` holding the *lower* factor element
    ``L[j, i]`` (``sum_k L[i,k] L[j,k] = P[i,j]``); expand with
    :func:`unpack_chol`.  Correlation-normalized with a relative pivot
    floor (same f32 stabilization as :func:`_chol_cols`); exactly-zero
    covariances (e.g. the Dirac initial state) factor to ~0.
    """
    pairs, where = _tri_idx(q)
    axis = axis % packed.ndim
    cols = [jnp.take(packed, k, axis=axis) for k in range(len(pairs))]
    tiny = jnp.asarray(jnp.finfo(packed.dtype).tiny, packed.dtype)
    d = [jnp.sqrt(jnp.maximum(cols[where[(i, i)]], tiny)) for i in range(q)]
    L = [[None] * (i + 1) for i in range(q)]
    ok = [None] * q
    for i in range(q):
        for j in range(i + 1):
            s = cols[where[(j, i)]] / (d[i] * d[j])
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                ok[i] = s > floor
                L[i][i] = jnp.sqrt(jnp.maximum(s, floor))
            else:
                # zero below floored pivots (rank-deficient factor) — see
                # _chol_cols: dividing by the floored pivot blows the
                # remaining columns up by ~1/floor
                L[i][j] = jnp.where(ok[j], s / L[j][j],
                                    jnp.zeros_like(s))
    out = [L[j][i] * d[j] for (i, j) in pairs]
    return jnp.stack(out, axis=axis)


def unpack_chol(packed):
    """Expand a packed lower-Cholesky factor (..., n_tri) as produced by
    :func:`chol_packed` into a dense lower-triangular (..., q, q) matrix
    (host-side convenience for lane slices of the square-root form's
    ``solve_mv_fused_batch`` output)."""
    n_tri = packed.shape[-1]
    q = {1: 1, 3: 2, 6: 3, 10: 4, 15: 5}[n_tri]
    pairs, _ = _tri_idx(q)
    where = {(i, j): k for k, (i, j) in enumerate(pairs)}
    zero = jnp.zeros_like(packed[..., 0])
    rows = [jnp.stack([packed[..., where[(j, i)]] if j <= i else zero
                       for j in range(q)], axis=-1) for i in range(q)]
    return jnp.stack(rows, axis=-2)


def _gain_cols_batched(q, n_tri, q_const, R_cols_b,
                       mf_cols, pf_cols, mpn_cols, ppn_cols):
    """Smoothing gains/offsets computed entirely in "column" layout
    (arrays of shape (T, n_block, n_lane)) via the same unrolled helpers
    the step functions use — no dense (q, q) trailing dims are ever
    materialized.

    Returns (G cols list-of-lists, g cols, L packed cols).
    """
    pairs, where = _tri_idx(q)
    ppinv = _sym_inv(q, ppn_cols)
    # T1 = Pf Q'  (T1[i][l] = sum_j Pf(i,j) Q[l][j])
    T1 = [[None] * q for _ in range(q)]
    for i in range(q):
        for l in range(q):
            acc = None
            for j in range(q):
                acc = _acc(acc, _coef_mul(
                    q_const[l][j], p_cols_at(pf_cols, where, i, j)))
            T1[i][l] = acc
    G = [[None] * q for _ in range(q)]
    for i in range(q):
        for l in range(q):
            acc = None
            for j in range(q):
                acc = _acc(acc, T1[i][j] * p_cols_at(ppinv, where, j, l))
            G[i][l] = acc
    g = []
    for i in range(q):
        acc = mf_cols[i]
        for j in range(q):
            acc = acc - G[i][j] * mpn_cols[j]
        g.append(acc)
    # Joseph offset: L = (I - G Q) Pf (I - G Q)' + G R G'
    IGQ = [[None] * q for _ in range(q)]
    for i in range(q):
        for j in range(q):
            acc = 1.0 if i == j else None
            s = None
            for k in range(q):
                s = _acc(s, _coef_mul(q_const[k][j], G[i][k]))
            if acc is None:
                IGQ[i][j] = -s
            else:
                IGQ[i][j] = 1.0 - s
    L = _sym_quadform(q, IGQ, pf_cols, where)
    GR = _sym_quadform(q, G, R_cols_b, where)
    L = [L[k] + GR[k] for k in range(n_tri)]
    return G, g, L


def _q_cols(prior_weight, q_const):
    """The transition as step-function coefficients: trace-time floats
    when it is block-constant (the IBM prior's Pascal matrix, turning the
    predict matmuls into sparse constant FMAs), else ``(n_block, 1)``
    columns."""
    if q_const is not None:
        return q_const
    q = prior_weight.shape[-1]
    qw = prior_weight.astype(jnp.float32)
    return [[qw[:, i, j][:, None] for j in range(q)] for i in range(q)]


# --- forward filter step -----------------------------------------------------


def _filter_step(mode, emit, Qm, R_cols, W_cols, tv_cols):
    r"""
    One lane-batched filter step, split around the ODE evaluation into
    ``predict(carry, eps_t) -> (pred, x_cols)`` and
    ``update(carry, pred, x_cols, f0, jd_cols) -> (carry, outs)``.

    Both halves are elementwise over the block and lane axes, so a driver
    may run them on whole ``(n_block, n_lane)`` tiles or block by block;
    only the ODE callables see all blocks at once.  ``carry`` is
    ``(m_cols, p_cols)``: the filtered mean (``q`` columns) and packed
    covariance (``n_tri`` columns).

    ``mode`` selects the interrogation scheme:

    - ``"kramer"``  (EK1): first-order linearization via ``jac_flat``,
      zero measurement noise;
    - ``"rodeo"``   (EK0): zero-order, noise :math:`V = W \Sigma_p W'`;
    - ``"schober"``: zero-order, zero noise;
    - ``"chkrebtii"``: like rodeo (same :math:`V`), but the ODE is
      evaluated at a draw :math:`x^* = \mu_p + \mathrm{chol}(\Sigma_p)
      \epsilon_n` with standard normals ``eps_t`` drawn outside.

    ``emit`` selects the per-step outputs:

    - ``"states"``: filtered mean/cov and predicted mean/cov;
    - ``"gains"``: the smoothing gains ``(G, g, L)`` of the transition
      ``n-1 -> n``, computed off the carry (filtered ``n-1``) and the
      fresh prediction (``n``), so the smoother needs no separate pass
      over the stored filter states.
    """
    q = len(W_cols)
    pairs, where = _tri_idx(q)
    n_tri = len(pairs)

    def predict(carry, eps_t):
        m_cols, p_cols = carry
        mp_cols = _matvec(q, Qm, m_cols)
        pp_cols = _sym_quadform(q, Qm, p_cols, where)
        pp_cols = [pp_cols[k] + R_cols[k] for k in range(n_tri)]
        if mode == "chkrebtii":
            # interrogate at a posterior-predictive draw (scaled coords)
            Lc = _chol_cols(q, pp_cols, where)
            eta = _chol_matvec(q, Lc, [eps_t[j] for j in range(q)])
            x_cols = [(mp_cols[j] + eta[j]) * tv_cols[j] for j in range(q)]
        else:
            # interrogation at the predicted mean (original coordinates)
            x_cols = [mp_cols[j] * tv_cols[j] for j in range(q)]
        return (mp_cols, pp_cols), x_cols

    def update(carry, pred, x_cols, f0, jd_cols):
        m_cols, p_cols = carry
        mp_cols, pp_cols = pred
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
        # PH = Pp H' ; S = H Pp H'
        PH_cols = []
        for i in range(q):
            acc = None
            for j in range(q):
                acc = _acc(acc, p_cols_at(pp_cols, where, i, j) * H_cols[j])
            PH_cols.append(acc)
        S = None
        for i in range(q):
            S = _acc(S, H_cols[i] * PH_cols[i])
        if mode in ("rodeo", "chkrebtii"):
            S = S + S                    # V = W Sigma_p W' doubles S
        inv_S = 1.0 / S
        gain = [PH_cols[i] * inv_S for i in range(q)]
        mf_cols = [mp_cols[i] + gain[i] * z for i in range(q)]
        # Joseph: (I - K H) Pp (I - K H)'  [+ K V K' for zero-order]
        IKW = [[(1.0 if i == j else 0.0) - gain[i] * H_cols[j]
                for j in range(q)] for i in range(q)]
        pf_cols = _sym_quadform(q, IKW, pp_cols, where)
        if mode in ("rodeo", "chkrebtii"):
            V = S * 0.5
            pf_cols = [pf_cols[k] + gain[i] * gain[j] * V
                       for k, (i, j) in enumerate(pairs)]
        if emit == "gains":
            G, g, L = _gain_cols_batched(q, n_tri, Qm, R_cols, m_cols,
                                         p_cols, mp_cols, pp_cols)
            outs = ([G[i][j] for i in range(q) for j in range(q)], g, L)
        else:
            outs = (mf_cols, pf_cols, mp_cols, pp_cols)
        return (mf_cols, pf_cols), outs

    return predict, update


def _ode_step(ode_flat, jac_flat, mode, predict, update, th):
    """Compose the two halves of :func:`_filter_step` around the ODE
    callables into one ``step(carry, (t_n, eps_t))`` on whole tiles."""

    def step(carry, x_t):
        t_n, eps_t = x_t
        pred, x_cols = predict(carry, eps_t)
        f0 = flat_call(ode_flat, x_cols, th, t_n)
        jd_cols = flat_call(jac_flat, x_cols, th, t_n) \
            if mode == "kramer" else [None] * len(x_cols)
        return update(carry, pred, x_cols, f0, jd_cols)

    return step


def fused_filter_batch(ode_flat, jac_flat, n_steps,
                       prior_weight, prior_var, ode_weight, x0_lanes,
                       theta_lanes, tgrid, t_vec, raw_q_const=None,
                       mode=None, eps=None, emit="states"):
    """Lane-batched forward filter (preconditioned inputs).

    ``ode_flat`` / ``jac_flat`` keep to the contract of
    :mod:`rodeo_tpu.ops.flat_rows`, on either driver.

    Args:
        x0_lanes (ndarray(q, n_block, n_lane)): Per-lane scaled initial
            states.
        theta_lanes (ndarray(n_theta, n_lane)): Per-lane parameters.
        mode (str | None): Interrogation scheme
            (``"kramer" | "rodeo" | "schober" | "chkrebtii"``; default
            ``"kramer"`` when ``jac_flat`` is given, else ``"rodeo"``).
        eps (ndarray(n_steps, q, n_block, n_lane) | None): Standard
            normals for the ``"chkrebtii"`` interrogation draws.
        emit (str): ``"states"`` (default) or ``"gains"`` — see
            :func:`_filter_step`.
        prior_weight, prior_var (ndarray(n_block, q, q)): scaled prior,
            shared across lanes; ``ode_weight`` ``(n_block, q)`` scaled.

    Returns:
        ``emit="states"``: 4 arrays of shape
        ``(n_steps, q | n_tri, n_block, n_lane)``: filtered mean/cov,
        predicted mean/cov (covs packed).

        ``emit="gains"``: 5 arrays — smoothing gains ``G``
        ``(n_steps, q*q, n_block, n_lane)`` (row-major ``i*q+j``),
        offsets ``g`` ``(n_steps, q, ...)``, Joseph covariances ``L``
        ``(n_steps, n_tri, ...)`` (entry ``n`` maps filtered ``n`` onto
        filtered ``n-1``, with entry 0 seeded by the initial state), and
        the final filtered mean ``(q, n_block, n_lane)`` / packed cov
        ``(n_tri, n_block, n_lane)``.
    """
    q, n_block, n_lane = x0_lanes.shape
    pairs, _ = _tri_idx(q)
    n_tri = len(pairs)
    if mode is None:
        mode = "kramer" if jac_flat is not None else "rodeo"
    if mode == "chkrebtii" and eps is None:
        raise ValueError("mode='chkrebtii' requires eps draws")
    q_const = _const_coefs(prior_weight)
    if q_const is None:
        q_const = raw_q_const
    R_packed = _pack_tri(prior_var, pairs).astype(jnp.float32)
    W = ode_weight.astype(jnp.float32)
    x0_lanes = x0_lanes.astype(jnp.float32)
    theta_lanes = theta_lanes.astype(jnp.float32)
    tgrid = tgrid.astype(jnp.float32)
    t_vec = t_vec.astype(jnp.float32)
    if eps is not None:
        eps = eps.astype(jnp.float32)
    if kernel_route() == "triton":
        from rodeo_tpu.ops import triton_kalman
        return triton_kalman.filter_batch(
            ode_flat, jac_flat, mode, emit, n_steps, q_const,
            prior_weight.astype(jnp.float32), R_packed, W, x0_lanes,
            theta_lanes, tgrid, t_vec, eps)
    predict, update = _filter_step(
        mode, emit, _q_cols(prior_weight, q_const),
        [R_packed[:, k:k + 1] for k in range(n_tri)],
        [W[:, j:j + 1] for j in range(q)],
        [t_vec[j] for j in range(q)])
    step = _ode_step(ode_flat, jac_flat, mode, predict, update, theta_lanes)
    carry0 = (list(x0_lanes),
              [jnp.zeros((n_block, n_lane), jnp.float32)] * n_tri)
    (m_last, p_last), outs = scan_steps(step, carry0, (tgrid, eps))
    if emit == "gains":
        return outs + (jnp.stack(m_last), jnp.stack(p_last))
    return outs


# --- backward smoother step --------------------------------------------------


def _smoother_step(q):
    """One step of the backward affine recursion
    ``m_n = g_n + G_n m_{n+1}``, ``P_n = L_n + G_n P_{n+1} G_n'`` over
    precomputed ``(g, G, L)``: ``step((m, P), (g_t, G_t, L_t))``, with
    ``G_t`` row-major; emits the smoothed ``(m, P)`` of step ``n``."""
    pairs, where = _tri_idx(q)
    n_tri = len(pairs)

    def step(carry, x_t):
        ms_cols, ps_cols = carry
        g_t, G_t, L_t = x_t
        G = [[G_t[i * q + j] for j in range(q)] for i in range(q)]
        m_out = []
        for i in range(q):
            acc = g_t[i]
            for j in range(q):
                acc = acc + G[i][j] * ms_cols[j]
            m_out.append(acc)
        gpg = _sym_quadform(q, G, ps_cols, where)
        p_out = [L_t[kk] + gpg[kk] for kk in range(n_tri)]
        return (m_out, p_out), (m_out, p_out)

    return step


def smoother_recursion_batch(g_k, G_k, L_k, mN, pN):
    r"""
    Lane-batched backward affine recursion
    ``m_n = g_n + G_n m_{n+1}``, ``P_n = L_n + G_n P_{n+1} G_n'`` — the
    smoothing workhorse of the batch paths.

    Args:
        g_k (ndarray(T, q, n_block, n_lane)): Offsets.
        G_k (ndarray(T, q*q, n_block, n_lane)): Gains, row-major.
        L_k (ndarray(T, n_tri, n_block, n_lane)): Packed noise terms.
        mN, pN: Terminal values ``(q, n_block, n_lane)`` /
            ``(n_tri, n_block, n_lane)``.

    Returns:
        (tuple): ``ms`` (T, q, n_block, n_lane), ``ps`` (T, n_tri,
        n_block, n_lane).
    """
    q = g_k.shape[1]
    g_k, G_k, L_k = (a.astype(jnp.float32) for a in (g_k, G_k, L_k))
    mN, pN = mN.astype(jnp.float32), pN.astype(jnp.float32)
    if kernel_route() == "triton":
        from rodeo_tpu.ops import triton_kalman
        return triton_kalman.smoother_batch(g_k, G_k, L_k, mN, pN)
    _, (ms, ps) = scan_steps(_smoother_step(q), (list(mN), list(pN)),
                             (g_k, G_k, L_k), reverse=True)
    return ms, ps


# --- solve entry points ------------------------------------------------------


def resolve_interrogation(interrogate, interrogation, jac_flat):
    """Resolve the fused interrogation ``mode`` from either the explicit
    ``interrogation=`` enum or the ``interrogate=`` callable of the
    :func:`rodeo_tpu.solve.solve_mv` API — validated, never silently
    ignored (a caller passing ``interrogate_chkrebtii`` must get chkrebtii
    semantics or an error, not a different algorithm)."""
    valid = ("kramer", "rodeo", "schober", "chkrebtii")
    if interrogation is not None:
        if interrogation not in valid:
            raise ValueError(
                f"interrogation must be one of {valid}, got "
                f"{interrogation!r}")
        mode = interrogation
    elif interrogate is None:
        mode = "kramer" if jac_flat is not None else "rodeo"
    else:
        from rodeo_tpu import interrogate as _imod
        by_callable = {
            _imod.interrogate_kramer: "kramer",
            _imod.interrogate_rodeo: "rodeo",
            _imod.interrogate_schober: "schober",
            _imod.interrogate_chkrebtii: "chkrebtii",
        }
        mode = by_callable.get(interrogate)
        if mode is None:
            raise ValueError(
                "the fused solvers support only the built-in "
                "interrogations (rodeo_tpu.interrogate.interrogate_"
                "{kramer,rodeo,schober,chkrebtii}); got an unrecognized "
                f"callable {interrogate!r} — use rodeo_tpu.solve / "
                "rodeo_tpu.ops.precond for custom interrogations")
    if mode == "kramer" and jac_flat is None:
        raise ValueError(
            "interrogation='kramer' (EK1) requires a `jac_flat` callable")
    return mode


def solve_mv_fused(key, ode_fun, ode_weight, ode_init,
                   t_min, t_max, n_steps,
                   interrogate=None,
                   prior_pars=None,
                   ode_flat=None, jac_flat=None,
                   interrogation=None, kalman_type="standard", **params):
    r"""
    Posterior mean/variance of one ODE solve on the fused path: the
    lane-batched solve (:func:`solve_mv_fused_batch`) with one lane.

    Matches :func:`rodeo_tpu.solve.solve_mv` (standard filter,
    Taylor-preconditioned internally) for configurations with one
    measurement row per block and ``q <= 5``.  The ODE enters through
    ``ode_flat(x_cols, th, t) -> (n_block, 1)`` and (for EK1)
    ``jac_flat(x_cols, th, t) -> [q columns or None]`` callables; models in
    :mod:`rodeo_tpu.models` provide them.  They may use only the
    operations listed in :mod:`rodeo_tpu.ops.flat_rows` (checked at trace
    time on every backend; others raise ``NotImplementedError``).

    The interrogation scheme is taken from ``interrogation=`` (``"kramer"
    | "rodeo" | "schober" | "chkrebtii"``) or inferred from a built-in
    ``interrogate=`` callable; default kramer when ``jac_flat`` is given,
    rodeo otherwise.  ``"chkrebtii"`` requires ``key``.  Unrecognized
    custom interrogations raise (use the XLA paths for those).

    With ``kalman_type="sqrt"`` (or ``"square-root"``) the returned
    variances are lower-Cholesky *factors* of the smoothed covariances,
    matching the square-root form's output contract
    (:mod:`rodeo_tpu.kalmantv.square_root`); the propagation itself is
    the same Joseph form, which is PSD-by-construction — see
    :func:`resolve_kalman_type`.

    Returns:
        (tuple): ``mean_state_smooth``, ``var_state_smooth`` with shapes
        ``(n_steps+1, n_block, q[, q])`` (``var`` is a Cholesky factor
        under the square-root form).
    """
    del ode_fun
    if ode_flat is None:
        raise ValueError(
            "solve_mv_fused requires an `ode_flat` callable "
            "(see rodeo_tpu.models.*_flat)")
    kalman_type = resolve_kalman_type(kalman_type)
    mode = resolve_interrogation(interrogate, interrogation, jac_flat)
    theta = params.get("theta")
    thetas = jnp.zeros((1, 1), jnp.float32) if theta is None \
        else jnp.asarray(theta)[None, :]
    mean, var = solve_mv_fused_batch(
        thetas, ode_weight, ode_init[None], t_min, t_max, n_steps,
        prior_pars, ode_flat, jac_flat, interrogation=mode, key=key,
        kalman_type=kalman_type)
    mean, var = mean[..., 0], var[..., 0]
    if kalman_type == "sqrt":
        return mean, unpack_chol(var)
    return mean, unpack_cov(var)


def _scaled_inputs(thetas, ode_weight, ode_inits, t_min, t_max, n_steps,
                   prior_pars):
    """Taylor-scaled, lane-major inputs shared by the batch entries."""
    n_block, n_bmeas, q = ode_weight.shape
    if n_bmeas != 1:
        raise NotImplementedError("fused solvers require n_bmeas == 1")
    dt = (t_max - t_min) / n_steps
    t_vec = taylor_scale(dt, q, dtype=jnp.float32)
    Qs, Rs = scale_prior(prior_pars, t_vec)
    q_const = _const_coefs(Qs)
    if q_const is None:
        q_const = _static_scaled_qconst(prior_pars[0], dt, q)
    W_s = (ode_weight * t_vec[None, None, :])[:, 0, :]
    x0_lanes = jnp.transpose(
        (ode_inits / t_vec).astype(jnp.float32), (2, 1, 0))   # (q, nb, B)
    tgrid = t_min + (t_max - t_min) * (jnp.arange(n_steps) + 1) / n_steps
    theta_lanes = jnp.transpose(thetas).astype(jnp.float32)
    return dict(t_vec=t_vec, Qs=Qs, Rs=Rs, q_const=q_const, W_s=W_s,
                x0_lanes=x0_lanes, tgrid=tgrid, theta_lanes=theta_lanes)


def solve_mv_fused_batch(thetas, ode_weight, ode_inits,
                         t_min, t_max, n_steps,
                         prior_pars,
                         ode_flat, jac_flat=None,
                         interrogation=None, key=None,
                         kalman_type="standard"):
    r"""
    Lane-batched fused solve: ``n_lane`` independent solves (parameter
    candidates / chains) through one forward filter and one backward
    smoother, batched over a trailing lane axis.

    The lane axis is LAST in all outputs and the covariance comes back
    packed upper-triangular; use ``unpack_cov(var[..., i])`` on a lane
    slice for a dense matrix.

    Args:
        thetas (ndarray(n_lane, n_theta)): Per-lane parameters.
        ode_inits (ndarray(n_lane, n_block, q)): Per-lane initial states
            (original coordinates).
        interrogation (str | None): ``"kramer" | "rodeo" | "schober" |
            "chkrebtii"`` (default kramer when ``jac_flat`` is given,
            rodeo otherwise).  ``"chkrebtii"`` interrogates at a
            posterior-predictive draw and requires ``key``.
        key (PRNGKey | None): PRNG key for stochastic interrogations.
        kalman_type (str): ``"standard"`` (packed covariances) or
            ``"sqrt"``/``"square-root"`` (packed lower-Cholesky factors,
            :func:`chol_packed` layout — expand a lane slice with
            :func:`unpack_chol`); see :func:`resolve_kalman_type`.
        (other args as :func:`solve_mv_fused`)

    Returns:
        (tuple):
        - **mean** (ndarray(n_steps+1, n_block, q, n_lane)).
        - **var_packed** (ndarray(n_steps+1, n_block, n_tri, n_lane)):
          packed covariances (standard) or packed factors (square-root).
    """
    n_lane = thetas.shape[0]
    n_block, _, q = ode_weight.shape
    kalman_type = resolve_kalman_type(kalman_type)
    prior_pars = normalize_prior_pars(kalman_type, prior_pars)
    pairs, _ = _tri_idx(q)
    n_tri = len(pairs)
    s = _scaled_inputs(thetas, ode_weight, ode_inits, t_min, t_max,
                       n_steps, prior_pars)
    t_vec, x0_lanes = s["t_vec"], s["x0_lanes"]

    eps = None
    if interrogation == "chkrebtii":
        if key is None:
            raise ValueError("interrogation='chkrebtii' requires a key")
        eps = jax.random.normal(
            key, (n_steps, q, n_block, n_lane), jnp.float32)
    # forward filter emitting the smoothing gains; entry 0 (conditioning
    # onto the Dirac initial state) is not needed by the smoother, whose
    # seed is the final filtered state
    A_k, b_k, C_k, m_last, p_last = fused_filter_batch(
        ode_flat, jac_flat, n_steps, s["Qs"], s["Rs"], s["W_s"], x0_lanes,
        s["theta_lanes"], s["tgrid"], t_vec, raw_q_const=s["q_const"],
        mode=interrogation, eps=eps, emit="gains")
    ms, ps = smoother_recursion_batch(b_k[1:], A_k[1:], C_k[1:],
                                      m_last, p_last)

    # assemble (N+1, nb, q | n_tri, B) in original coordinates, lanes last
    def rows(a):  # (T, d, nb, B) -> (T, nb, d, B)
        return jnp.transpose(a, (0, 2, 1, 3))

    t_col = t_vec.astype(jnp.float32)[:, None]                # (q, 1)
    mean_rows = jnp.concatenate([
        jnp.transpose(x0_lanes, (1, 0, 2))[None],             # (1, nb, q, B)
        rows(ms),
        rows(m_last[None]),
    ], axis=0) * t_col
    packed_rows = jnp.concatenate([
        jnp.zeros((1, n_block, n_tri, n_lane), jnp.float32),
        rows(ps),
        rows(p_last[None]),
    ], axis=0)
    if kalman_type == "sqrt":
        # factor the scaled covariances in packed layout, then unscale
        # the factor rows (entry k=(i,j) is dense L[j][i], i.e. row j)
        f_rows = chol_packed(packed_rows, q, axis=-2)
        row_scale = jnp.stack(
            [t_vec[j] for (_, j) in pairs]).astype(jnp.float32)
        return mean_rows, f_rows * row_scale[:, None]
    tri_scale = jnp.stack(
        [t_vec[i] * t_vec[j] for (i, j) in pairs]).astype(jnp.float32)
    return mean_rows, packed_rows * tri_scale[:, None]


def _smoother_mean_step_tan(q, n_tan):
    """Tangent-augmented backward MEAN step: primal ``m = g + G m⁺`` with
    ``n_tan`` tangent rows ``dm_k = dg_k + dG_k m⁺ + G dm_k⁺``; offsets and
    gains arrive with primal + tangents stacked on the d axis."""

    def step(carry, x_t):
        g_t, G_t = x_t
        m_cols = carry[:q]
        G = [[G_t[i * q + j] for j in range(q)] for i in range(q)]
        outs = []
        for i in range(q):
            acc = g_t[i]
            for j in range(q):
                acc = acc + G[i][j] * m_cols[j]
            outs.append(acc)
        for t in range(n_tan):
            dm_cols = carry[(1 + t) * q:(2 + t) * q]
            for i in range(q):
                acc = g_t[(1 + t) * q + i]
                for j in range(q):
                    acc = acc + G_t[(1 + t) * q * q + i * q + j] \
                        * m_cols[j] + G[i][j] * dm_cols[j]
                outs.append(acc)
        return outs, (outs,)

    return step


def smoother_mean_recursion_batch_tan(g_aug, G_aug, mN_aug, n_tan):
    r"""
    Tangent-augmented lane-batched backward affine MEAN recursion: primal
    ``m = g + G m⁺`` with ``n_tan`` tangent rows
    ``dm_k = dg_k + dG_k m⁺ + G dm_k⁺`` (the derivative recursion of the
    smoothing pass — shared by the fused solve, basic and daltonng
    gradient paths).

    Args:
        g_aug (ndarray(T, (1+n_tan)*q, nb, B)): Primal + tangent offsets.
        G_aug (ndarray(T, (1+n_tan)*q*q, nb, B)): Primal + tangent gains,
            row-major per block.
        mN_aug (ndarray((1+n_tan)*q, nb, B)): Terminal values.

    Returns:
        (ndarray(T, (1+n_tan)*q, nb, B)): Smoothed means + tangents.
    """
    q = g_aug.shape[1] // (1 + n_tan)
    _, (ms,) = scan_steps(
        _smoother_mean_step_tan(q, n_tan),
        list(mN_aug.astype(jnp.float32)),
        (g_aug.astype(jnp.float32), G_aug.astype(jnp.float32)),
        reverse=True)
    return ms


def solve_mv_fused_batch_grad(thetas, ode_weight, ode_inits,
                              t_min, t_max, n_steps,
                              prior_pars,
                              ode_flat, jac_flat=None,
                              kalman_type="standard"):
    r"""
    Lane-batched fused solve posterior mean AND its theta-sensitivities
    via forward-mode tangent augmentation: the tangent filter of
    :mod:`rodeo_tpu.ops.pallas_fenrir`, `jax.jvp` through the smoothing
    gains, and a tangent-augmented backward mean recursion.  This is the
    fused-speed substrate for likelihood gradients whose observation
    model consumes the solution mean (``basic``), and for
    d(solution)/d(theta) sensitivity analysis generally.

    ``ode_inits`` must not depend on theta (tangents seeded zero); EK0/EK1
    interrogations only (``jac_flat`` selects EK1).

    Returns:
        (tuple):
        - **mean** (ndarray(n_steps+1, n_block, q, n_lane)): as
          :func:`solve_mv_fused_batch`.
        - **dmean** (ndarray(n_theta, n_steps+1, n_block, q, n_lane)):
          per-parameter directional derivatives of **mean**.
    """
    from rodeo_tpu.ops.pallas_fenrir import fused_filter_batch_tan

    kalman_type = resolve_kalman_type(kalman_type)
    prior_pars = normalize_prior_pars(kalman_type, prior_pars)
    n_lane, n_theta = thetas.shape
    n_tan = n_theta
    n_block, _, q = ode_weight.shape
    s = _scaled_inputs(thetas, ode_weight, ode_inits, t_min, t_max,
                       n_steps, prior_pars)
    if s["q_const"] is None:
        raise NotImplementedError(
            "solve_mv_fused_batch_grad requires a block-constant "
            "transition available at trace time")
    t_vec, x0_lanes = s["t_vec"], s["x0_lanes"]
    mode = "kramer" if jac_flat is not None else "rodeo"

    # tangent-augmented filter emitting the smoothing gains (and their
    # tangents); entry 0 conditions onto the Dirac init and is not needed
    A_aug, b_aug, _, mlast_a, _ = fused_filter_batch_tan(
        ode_flat, jac_flat, mode, n_tan, n_steps, s["Qs"], s["Rs"],
        s["W_s"], x0_lanes, s["theta_lanes"], s["tgrid"], t_vec,
        s["q_const"], emit="gains")
    ms_aug = smoother_mean_recursion_batch_tan(
        b_aug[1:], A_aug[1:], mlast_a, n_tan)

    def rows(a):  # (T, d, nb, B) -> (T, nb, d, B)
        return jnp.transpose(a, (0, 2, 1, 3))

    t_col = t_vec.astype(jnp.float32)[:, None]                # (q, 1)
    mean_rows = jnp.concatenate([
        jnp.transpose(x0_lanes, (1, 0, 2))[None],
        rows(ms_aug[:, :q]),
        rows(mlast_a[None, :q]),
    ], axis=0) * t_col
    dmeans = []
    for k in range(n_tan):
        sl = slice((1 + k) * q, (2 + k) * q)
        dmeans.append(jnp.concatenate([
            jnp.zeros((1, n_block, q, n_lane), jnp.float32),  # x0: dtheta 0
            rows(ms_aug[:, sl]),
            rows(mlast_a[None, sl]),
        ], axis=0) * t_col)
    return mean_rows, jnp.stack(dmeans)


def basic_fused_batch_grad(thetas, ode_weight, ode_inits,
                           t_min, t_max, n_steps,
                           prior_pars,
                           obs_data, obs_times, obs_loglik,
                           ode_flat, jac_flat=None,
                           kalman_type="standard", **params):
    r"""
    Lane-batched fused Basic likelihood AND its theta-gradient: the
    tangent-augmented fused solve (:func:`solve_mv_fused_batch_grad`)
    chained through the user ``obs_loglik`` by `jax.jvp` — the MAP /
    gradient-MCMC workload for plug-in likelihoods at fused speed.

    Returns:
        (tuple): ``loglik (n_lane,)``, ``grad (n_lane, n_theta)``,
        ``mean (n_steps+1, n_block, q, n_lane)``.
    """
    kalman_type = resolve_kalman_type(kalman_type)
    prior_pars = normalize_prior_pars(kalman_type, prior_pars)
    mean_rows, dmean = solve_mv_fused_batch_grad(
        thetas=thetas, ode_weight=ode_weight, ode_inits=ode_inits,
        t_min=t_min, t_max=t_max, n_steps=n_steps, prior_pars=prior_pars,
        ode_flat=ode_flat, jac_flat=jac_flat)
    sim_times = jnp.linspace(t_min, t_max, n_steps + 1)
    obs_ind = jnp.searchsorted(sim_times, obs_times)

    def lls_of(ode_rows):
        ode_obs = ode_rows[obs_ind]               # (n_obs, nb, q, n_lane)
        return jax.vmap(lambda od: obs_loglik(obs_data, od, **params),
                        in_axes=-1)(ode_obs)

    lls = lls_of(mean_rows)
    grads = [jax.jvp(lls_of, (mean_rows,), (dmean[k],))[1]
             for k in range(dmean.shape[0])]
    return lls, jnp.stack(grads, axis=-1), mean_rows


# --- stationary-gain path ----------------------------------------------------
#
# When the interrogation's measurement matrix H is constant in time — EK0
# always (H = W), EK1 whenever the model's block-diagonal Jacobian is
# state-independent (e.g. Lorenz63) — the covariance/gain Riccati
# recursion is autonomous and converges geometrically to its fixed point:
# on the Lorenz63-10k config the Kalman gain is within 4e-7 (relative) of
# steady state after 10 steps, i.e. constant at f32 resolution.  So run
# an exact n_warm-step prefix, freeze the gain, and the remaining
# sequential work is ONLY the (nonlinear, irreducible) mean chain.


def solve_mv_fused_stationary(key, ode_fun, ode_weight, ode_init,
                              t_min, t_max, n_steps,
                              interrogate=None,
                              prior_pars=None,
                              ode_flat=None, jac_flat=None,
                              n_warm=64, interrogation=None,
                              kalman_type="standard", **params):
    r"""
    :func:`solve_mv_fused` specialization for time-constant measurement
    matrices (see the section comment above): exact ``n_warm``-step
    Riccati prefix, steady-state gains beyond it, a mean-only sequential
    chain, and the backward smoother over the frozen covariances.

    VALIDITY: EK0 (``interrogation="rodeo"``) for any model; EK1
    (``"kramer"``) only when ``jac_flat`` is state-independent (the
    caller asserts this — e.g. Lorenz63's in-block Jacobian).  Same
    return contract as :func:`solve_mv_fused` (including the square-root
    form's Cholesky-factor variances under ``kalman_type="sqrt"``).
    """
    del key, ode_fun
    kalman_type = resolve_kalman_type(kalman_type)
    prior_pars = normalize_prior_pars(kalman_type, prior_pars)
    if ode_flat is None:
        raise ValueError(
            "solve_mv_fused_stationary requires an `ode_flat` callable")
    mean_out, var_out = _solve_mv_fused_stationary_impl(
        ode_weight, ode_init, t_min, t_max, n_steps, interrogate,
        prior_pars, ode_flat, jac_flat, n_warm, interrogation, **params)
    if kalman_type == "sqrt":
        from rodeo_tpu.ops.linalg import chol_small
        var_out = chol_small(var_out)
    return mean_out, var_out


def _solve_mv_fused_stationary_impl(ode_weight, ode_init, t_min, t_max,
                                    n_steps, interrogate, prior_pars,
                                    ode_flat, jac_flat, n_warm,
                                    interrogation, **params):
    # the assembly below uses unrolled elementwise column sums, never
    # matmuls: on the ~1e6-magnitude Taylor-scaled quantities a reduced-
    # precision dot seeds perturbations that chaotic dynamics amplify
    mode = resolve_interrogation(interrogate, interrogation, jac_flat)
    if mode not in ("kramer", "rodeo"):
        raise NotImplementedError(
            "stationary gains require a deterministic time-constant "
            "interrogation (kramer with state-independent Jacobian, or "
            "rodeo)")
    theta = params.get("theta")
    thetas = jnp.zeros((1, 1), jnp.float32) if theta is None \
        else jnp.asarray(theta)[None, :]
    n_block, _, q = ode_weight.shape
    pairs, where = _tri_idx(q)
    n_tri = len(pairs)
    s = _scaled_inputs(thetas, ode_weight, ode_init[None], t_min, t_max,
                       n_steps, prior_pars)
    t_vec, tgrid, q_const = s["t_vec"], s["tgrid"], s["q_const"]
    if q_const is None:
        raise NotImplementedError(
            "solve_mv_fused_stationary requires a block-constant "
            "transition available at trace time")
    W_s = s["W_s"].astype(jnp.float32)
    theta_col = s["theta_lanes"]                          # (n_theta, 1)
    x0_s = s["x0_lanes"][..., 0].T                        # (nb, q)
    n_warm = min(n_warm, n_steps)

    def blocks(a):  # (T, d, nb, 1) -> (T, nb, d)
        return jnp.transpose(a[..., 0], (0, 2, 1))

    # --- exact Riccati prefix (the batched filter, one lane) ------------
    mfw, pfw, mpw, ppw = (blocks(a) for a in fused_filter_batch(
        ode_flat, jac_flat, n_warm, s["Qs"], s["Rs"], W_s, s["x0_lanes"],
        theta_col, tgrid[:n_warm], t_vec, raw_q_const=q_const, mode=mode))

    # constant H (nb, q): EK0 -> W; EK1 -> W - jac * t (jac evaluated at a
    # dummy state: state-independence is the validity contract)
    if mode == "kramer":
        dummy = [jnp.zeros((n_block, 1), jnp.float32) for _ in range(q)]
        jd = flat_call(jac_flat, dummy, theta_col, jnp.float32(t_min))
        H = W_s - jnp.concatenate(
            [(jd[j] if jd[j] is not None else
              jnp.zeros((n_block, 1), jnp.float32)) * t_vec[j]
             for j in range(q)], axis=1)
    else:
        H = W_s

    # gains from the prefix predicted covariances + frozen steady state
    ppw_d = _unpack_tri(ppw, q, pairs)                    # (n_warm,nb,q,q)
    PH = sum(ppw_d[..., j] * H[None, :, None, j] for j in range(q))
    S = sum(H[None, :, i] * PH[..., i] for i in range(q))
    if mode == "rodeo":
        S = 2.0 * S
    K_pre = PH / S[..., None]                             # (n_warm,nb,q)
    gains = jnp.concatenate([
        K_pre,
        jnp.broadcast_to(K_pre[-1], (n_steps - n_warm, n_block, q)),
    ], axis=0).astype(jnp.float32)

    # --- mean chain with streamed gains ---------------------------------
    # the innovation reduces to z = f(x_pred) - W mu_pred for BOTH EK0
    # and EK1 (the Jacobian terms of H mu + mm cancel exactly)
    Qm = _q_cols(s["Qs"], q_const)
    W_cols = [W_s[:, j:j + 1] for j in range(q)]

    def mean_step(m_cols, x_t):
        t_n, K_t = x_t
        mp_cols = _matvec(q, Qm, m_cols)
        x_cols = [mp_cols[j] * t_vec[j] for j in range(q)]
        f0 = flat_call(ode_flat, x_cols, theta_col, t_n)
        wm = None
        for j in range(q):
            wm = _acc(wm, W_cols[j] * mp_cols[j])
        z = f0 - wm
        mf_cols = [mp_cols[i] + K_t[:, i:i + 1] * z for i in range(q)]
        return mf_cols, jnp.concatenate(mf_cols, axis=1)

    _, mf = scan(mean_step, [x0_s[:, j:j + 1] for j in range(q)],
                 (tgrid.astype(jnp.float32), gains))      # (N, nb, q)

    # predicted means recovered batched: mp_n = Q mf_{n-1} (mp_1 = Q x0)
    prev = jnp.concatenate([x0_s[None], mf[:-1]], axis=0)
    prev_cols = [prev[..., j:j + 1] for j in range(q)]
    mp = jnp.concatenate(_matvec(q, Qm, prev_cols), axis=-1)

    # full-horizon covariances: exact prefix + frozen steady state
    pf = jnp.concatenate([pfw, jnp.broadcast_to(
        pfw[-1], (n_steps - n_warm, n_block, n_tri))], axis=0)
    pp = jnp.concatenate([ppw, jnp.broadcast_to(
        ppw[-1], (n_steps - n_warm, n_block, n_tri))], axis=0)

    # --- backward smoother over steps 1..N-1 ----------------------------
    R_packed = _pack_tri(s["Rs"], pairs).astype(jnp.float32)
    G, g, L = _gain_cols_batched(
        q, n_tri, Qm, [R_packed[None, :, k] for k in range(n_tri)],
        [mf[:-1, :, j] for j in range(q)],
        [pf[:-1, :, k] for k in range(n_tri)],
        [mp[1:, :, j] for j in range(q)],
        [pp[1:, :, k] for k in range(n_tri)])

    def lanes(cols):  # list of (T, nb) -> (T, d, nb, 1)
        return jnp.stack(cols, axis=1)[..., None]

    ms, ps = smoother_recursion_batch(
        lanes(g), lanes([G[i][j] for i in range(q) for j in range(q)]),
        lanes(L), mf[-1].T[..., None], pf[-1].T[..., None])
    ms = jnp.concatenate([blocks(ms), mf[-1][None]], axis=0)   # rows 1..N
    Ps = _unpack_tri(jnp.concatenate([blocks(ps), pf[-1][None]], axis=0),
                     q, pairs)

    # assemble rows 0..N in original coordinates
    t_v = t_vec.astype(jnp.float32)
    mean_out = jnp.concatenate([x0_s[None], ms]) * t_v
    var_rows = jnp.concatenate(
        [jnp.zeros((1, n_block, q, q), jnp.float32), Ps])
    var_out = var_rows * (t_v[:, None] * t_v[None, :])
    return mean_out, var_out


def basic_fused_batch(thetas, ode_weight, ode_inits,
                      t_min, t_max, n_steps,
                      prior_pars,
                      obs_data, obs_times, obs_loglik,
                      ode_flat, jac_flat=None, interrogation=None,
                      key=None, kalman_type="standard", **params):
    r"""
    Lane-batched fused Basic likelihood: ``n_lane`` plug-in likelihood
    evaluations per pipeline — the fused ``solve_mv`` forward pass
    (:func:`solve_mv_fused_batch`) followed by one batched user
    ``obs_loglik`` evaluation at the smoothed means.  Parity: upstream
    ``basic.py:47-62`` semantics, lane-batched.

    Args:
        obs_loglik (Callable): ``obs_loglik(obs_data, ode_data, **params)``
            as in :func:`rodeo_tpu.inference.basic`.
        (other args as :func:`solve_mv_fused_batch`)

    Returns:
        (tuple):
        - **loglik** (ndarray(n_lane,)).
        - **mean** (ndarray(n_steps+1, n_block, q, n_lane)): solution
          posterior mean (all grid rows, lanes last).
    """
    # the Basic likelihood plugs in the posterior MEAN only, which is
    # identical under both filter forms (see resolve_kalman_type) —
    # validate, accept the sqrt caller's factor-form prior, and ride the
    # shared pipeline
    kalman_type = resolve_kalman_type(kalman_type)
    prior_pars = normalize_prior_pars(kalman_type, prior_pars)
    mean_rows, _ = solve_mv_fused_batch(
        thetas=thetas, ode_weight=ode_weight, ode_inits=ode_inits,
        t_min=t_min, t_max=t_max, n_steps=n_steps, prior_pars=prior_pars,
        ode_flat=ode_flat, jac_flat=jac_flat,
        interrogation=interrogation, key=key)
    sim_times = jnp.linspace(t_min, t_max, n_steps + 1)
    obs_ind = jnp.searchsorted(sim_times, obs_times)
    ode_obs = mean_rows[obs_ind]                  # (n_obs, nb, q, n_lane)
    lls = jax.vmap(lambda od: obs_loglik(obs_data, od, **params),
                   in_axes=-1)(ode_obs)
    return lls, mean_rows


def unpack_cov(packed):
    """Expand a packed upper-triangular covariance (..., n_tri) into a
    dense symmetric (..., q, q) matrix (host-side convenience for slices
    of :func:`solve_mv_fused_batch` output)."""
    n_tri = packed.shape[-1]
    q = {1: 1, 3: 2, 6: 3, 10: 4, 15: 5}[n_tri]
    pairs, _ = _tri_idx(q)
    return _unpack_tri(packed, q, pairs)
