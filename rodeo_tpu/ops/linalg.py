r"""
Fast closed-form linear algebra for tiny matrices.

The solver state is block-diagonal with blocks of size :math:`q \le 4` and
measurement dimension typically 1, yet every filter/smoother step calls
``jnp.linalg.solve`` — a general batched LU routine whose fixed cost
dwarfs the actual arithmetic of a tiny matrix.  For ``n in {1, 2, 3}`` the
solve has an exact closed form (division / adjugate), which lowers to a
handful of elementwise ops and fuses into the surrounding computation.

The closed forms lose ``cond(A) * eps`` accuracy, so they are only enabled
inside the Taylor-preconditioned code paths (where all matrices are O(1)
conditioned; see :mod:`rodeo_tpu.ops.precond`) via the :func:`fast_linalg`
context.  The default path keeps LAPACK-accurate solves for reference
parity.
"""
import contextlib
import contextvars
import functools

import jax
import jax.numpy as jnp

__all__ = ["fast_linalg", "fast_linalg_enabled", "solve_small", "solve_psd",
           "inv_small", "sym_eigh_small", "chol_small",
           "tri_solve_small", "matmul_small", "full_matmul_precision"]


def full_matmul_precision(fn):
    r"""
    Trace ``fn`` under ``jax.default_matmul_precision("highest")``.

    An accelerator's default float32 ``dot_general`` may run at reduced
    precision (TF32 on a GPU's tensor cores keeps ~3 decimal digits);
    over thousands of sequential filter steps on a chaotic system that
    rounding is amplified catastrophically, far past what float32
    itself does on the problem (the f32-on-CPU control).  The per-step
    operands are tiny (q <= 4), so full-precision products cost nothing
    measurable there.

    Applied to every public solver/inference entry point; the fused step
    functions use elementwise f32 arithmetic and are unaffected.  No-op
    on CPU (f32 matmuls are exact there) — reference parity in f64 is
    untouched.
    """
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapped

_FAST = contextvars.ContextVar("rodeo_tpu_fast_linalg", default=False)


@contextlib.contextmanager
def fast_linalg(enable=True):
    """Enable closed-form tiny-matrix solves within the context (trace-time
    static switch; capture it inside jitted functions by tracing under the
    context)."""
    token = _FAST.set(enable)
    try:
        yield
    finally:
        _FAST.reset(token)


def fast_linalg_enabled():
    return _FAST.get()


def _det2(a):
    return a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]


def inv_small(a):
    """Closed-form inverse for trailing dims up to 5x5 (batched).

    Scale-normalized: the determinant of an n x n adjugate grows like
    ``|a|**n``, which overflows float32 for entry magnitudes beyond ~1e12,
    so the matrix is divided by its max-abs entry first.
    """
    n = a.shape[-1]
    if n == 1:
        return 1.0 / a
    scale = jnp.max(jnp.abs(a), axis=(-1, -2), keepdims=True)
    scale = jnp.where(scale == 0, 1.0, scale)
    a = a / scale
    return _inv_small_normed(a) / scale


def _inv_small_normed(a):
    n = a.shape[-1]
    if n == 2:
        det = _det2(a)[..., None, None]
        adj = jnp.stack([
            jnp.stack([a[..., 1, 1], -a[..., 0, 1]], axis=-1),
            jnp.stack([-a[..., 1, 0], a[..., 0, 0]], axis=-1),
        ], axis=-2)
        return adj / det
    if n == 3:
        m00, m01, m02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
        m10, m11, m12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
        m20, m21, m22 = a[..., 2, 0], a[..., 2, 1], a[..., 2, 2]
        c00 = m11 * m22 - m12 * m21
        c01 = m12 * m20 - m10 * m22
        c02 = m10 * m21 - m11 * m20
        c10 = m02 * m21 - m01 * m22
        c11 = m00 * m22 - m02 * m20
        c12 = m01 * m20 - m00 * m21
        c20 = m01 * m12 - m02 * m11
        c21 = m02 * m10 - m00 * m12
        c22 = m00 * m11 - m01 * m10
        det = m00 * c00 + m01 * c01 + m02 * c02
        adj = jnp.stack([
            jnp.stack([c00, c10, c20], axis=-1),
            jnp.stack([c01, c11, c21], axis=-1),
            jnp.stack([c02, c12, c22], axis=-1),
        ], axis=-2)
        return adj / det[..., None, None]
    if n in (4, 5):
        # one level of 2+(n-2) block partitioning (Schur complement),
        # recursing into the direct cofactor forms
        k = 2
        A, B = a[..., :k, :k], a[..., :k, k:]
        Cc, D = a[..., k:, :k], a[..., k:, k:]
        Ainv = _inv_small_normed(A)
        AinvB = Ainv @ B
        CAinv = Cc @ Ainv
        Sinv = _inv_small_normed(D - CAinv @ B)
        UR = -(AinvB @ Sinv)
        UL = Ainv - UR @ CAinv
        LL = -(Sinv @ CAinv)
        top = jnp.concatenate([UL, UR], axis=-1)
        bot = jnp.concatenate([LL, Sinv], axis=-1)
        return jnp.concatenate([top, bot], axis=-2)
    raise ValueError(f"inv_small supports n in (1, ..., 5), got {n}")


def _det_small_normed(a):
    """Closed-form determinant for trailing dims up to 5x5 (batched);
    n = 4, 5 via the Schur split det(M) = det(A) det(D - C A^{-1} B)."""
    n = a.shape[-1]
    if n == 1:
        return a[..., 0, 0]
    if n == 2:
        return _det2(a)
    if n == 3:
        m00, m01, m02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
        m10, m11, m12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
        m20, m21, m22 = a[..., 2, 0], a[..., 2, 1], a[..., 2, 2]
        return (m00 * (m11 * m22 - m12 * m21)
                + m01 * (m12 * m20 - m10 * m22)
                + m02 * (m10 * m21 - m11 * m20))
    if n in (4, 5):
        k = 2
        A, B = a[..., :k, :k], a[..., :k, k:]
        Cc, D = a[..., k:, :k], a[..., k:, k:]
        S = D - Cc @ _inv_small_normed(A) @ B
        return _det2(A) * _det_small_normed(S)
    raise ValueError(f"det_small supports n in (1, ..., 5), got {n}")


def mvn_logpdf_small(x, mean, cov):
    r"""
    Multivariate-normal log-density via closed-form determinant + solve
    for trailing dims up to 5 — no eigendecomposition (``jnp.linalg.eigh``
    of tiny matrices is an iterative routine whose cost dwarfs the
    arithmetic).  Scale-normalized against f32 overflow; requires
    a positive-definite covariance (use
    :func:`rodeo_tpu.utils.multivariate_normal_logpdf` for singular
    covariances).

    Batched over leading dims; returns ``(...)`` log-density values.
    """
    n = cov.shape[-1]
    scale = jnp.max(jnp.abs(cov), axis=(-1, -2), keepdims=True)
    scale = jnp.where(scale == 0, 1.0, scale)
    det_n = _det_small_normed(cov / scale)
    tiny = jnp.asarray(jnp.finfo(cov.dtype).tiny, cov.dtype)
    logdet = (n * jnp.log(scale[..., 0, 0])
              + jnp.log(jnp.maximum(det_n, tiny)))
    z = x - mean
    quad = jnp.sum(z * solve_small(cov, z), axis=-1)
    log2pi = jnp.asarray(1.8378770664093453, cov.dtype)
    return -0.5 * (quad + logdet + n * log2pi)


def solve_small(a, b):
    """
    ``a^{-1} b`` with a closed form when the trailing dimension of ``a`` is
    at most 5 *and* :func:`fast_linalg` is active; falls back to
    ``jnp.linalg.solve`` otherwise.  ``b`` may be a matrix (``(..., n, k)``)
    or a vector (``(..., n)``).
    """
    n = a.shape[-1]
    if not _FAST.get() or n > 5:
        if b.ndim == a.ndim - 1:
            # explicit vector solve: numpy-2 semantics treat any
            # b.ndim >= 2 as a matrix stack, which mis-broadcasts
            # batched vector right-hand sides
            return jnp.linalg.solve(a, b[..., None])[..., 0]
        return jnp.linalg.solve(a, b)
    if b.ndim == a.ndim - 1:
        if n == 1:
            return b / a[..., 0]
        return jnp.einsum("...ij,...j->...i", inv_small(a), b)
    if n == 1:
        return b / a
    return inv_small(a) @ b


def solve_psd(a, b):
    r"""
    ``a^{-1} b`` for **symmetric positive-definite** ``a``.

    Dispatch (trailing dim :math:`n`, :func:`fast_linalg` state):

    * default (``fast_linalg`` off): batched LU via :func:`solve_small` —
      bit-identical to the reference's ``jnp.linalg.solve`` path
      (upstream ``rodeo/utils.py:105-119``, which ships the Cholesky
      variant commented out);
    * ``fast_linalg`` on, :math:`n \le 5`: closed-form adjugate solve
      (:func:`solve_small`) — a handful of elementwise ops;
    * ``fast_linalg`` on, :math:`n > 5`: Cholesky + two triangular solves,
      roughly half the work of the general batched LU of
      ``jnp.linalg.solve`` and *more* accurate on PD inputs (which of the
      two is faster on a given device is not measured here).  Requires
      genuinely PD ``a`` — ``fast_linalg`` is the
      caller's assertion that its matrices are well-conditioned (the
      Taylor-preconditioned paths guarantee this).

    ``b`` may be a matrix ``(..., n, k)`` or a vector ``(..., n)``;
    batched over leading dims.
    """
    n = a.shape[-1]
    if not _FAST.get() or n <= 5:
        return solve_small(a, b)
    import jax.scipy.linalg as jsp_linalg
    vector = b.ndim == a.ndim - 1
    bb = b[..., None] if vector else b
    chol = jnp.linalg.cholesky(a)
    y = jsp_linalg.solve_triangular(chol, bb, lower=True)
    x = jsp_linalg.solve_triangular(chol, y, lower=True, trans=1)
    return x[..., 0] if vector else x


@jax.custom_jvp
def psd_factor_eigh(cov):
    r"""
    PSD factor :math:`L = V \operatorname{diag}(\sqrt{\max(w, 0)})` with
    :math:`L L' = \mathrm{cov}` from a symmetric eigendecomposition —
    numerically identical to the inline ``eigh`` factor the samplers use,
    but with a **gradient-safe** custom JVP: the stock eigh derivative has
    :math:`1/(\lambda_j - \lambda_i)` eigenvector terms that NaN whenever
    eigenvalues coincide or vanish (guaranteed at the exact-init end of a
    smoothing pass), which silently poisoned ``jax.grad`` through
    ``solve_sim(method="eigh")``.  The JVP below clamps those denominators
    (exact wherever the eigensystem is simple; a bounded surrogate on the
    degenerate set, where the eigenvector derivative itself is
    non-unique).
    """
    w, v = jnp.linalg.eigh(cov)
    return v * jnp.sqrt(jnp.maximum(w, 0.0))[..., None, :]


@psd_factor_eigh.defjvp
def _psd_factor_eigh_jvp(primals, tangents):
    (cov,), (dcov,) = primals, tangents
    w, v = jnp.linalg.eigh(cov)
    wc = jnp.maximum(w, 0.0)
    sqw = jnp.sqrt(wc)
    primal_out = v * sqw[..., None, :]
    vt_dc_v = jnp.swapaxes(v, -1, -2) @ dcov @ v
    dw = jnp.diagonal(vt_dc_v, axis1=-2, axis2=-1)
    diff = w[..., None, :] - w[..., :, None]          # lambda_j - lambda_i
    eps = jnp.asarray(jnp.finfo(w.dtype).eps, w.dtype)
    scale = jnp.maximum(jnp.abs(w[..., -1:]), 1.0)[..., None]
    f = diff / (diff * diff + (eps * scale) ** 2)     # safe 1/(lj - li)
    eye = jnp.eye(w.shape[-1], dtype=w.dtype)
    f = f * (1.0 - eye)
    dv = v @ (f * vt_dc_v)
    # Clamped directions (w <= tol*scale, incl. the exact-zero covariances
    # this factor exists to handle): d/dt sqrt(max(w,0)) = 0 there, and the
    # bounded surrogate dw/(2*sqw + eps*scale) ~ dw/eps would be a finite
    # but astronomically wrong contribution — mask it to the true zero.
    tol = jnp.sqrt(eps)
    live = w > tol * scale[..., 0]
    dsqw = jnp.where(live, dw / (2.0 * sqw + eps * scale[..., 0]), 0.0)
    d_out = dv * sqw[..., None, :] + v * dsqw[..., None, :]
    return primal_out, d_out


def sym_eigh_small(a):
    r"""
    Closed-form symmetric eigendecomposition for trailing dims up to 3
    (batched, elementwise ops only — ``jnp.linalg.eigh`` of millions of
    tiny matrices lowers to an iterative routine whose cost dwarfs the
    arithmetic).

    Eigenvalues by the trigonometric solution of the characteristic
    cubic; eigenvectors by the Cayley–Hamilton construction
    :math:`v_i \propto` columns of :math:`\prod_{j \ne i}(A - \lambda_j I)`
    (largest column chosen per batch element).  Scale-normalized.  For a
    numerically repeated eigenvalue the individual eigenvectors are
    ill-determined (as with any method); downstream masked-quadratic
    users are insensitive to the within-subspace basis.

    Returns ``(w, v)`` with eigenvalues ascending, like ``jnp.linalg.eigh``.
    """
    n = a.shape[-1]
    if n == 1:
        return a[..., 0], jnp.ones_like(a)
    scale = jnp.max(jnp.abs(a), axis=(-1, -2), keepdims=True)
    scale = jnp.where(scale == 0, 1.0, scale)
    A = a / scale
    eye = jnp.eye(n, dtype=a.dtype)
    if n == 2:
        a00, a01, a11 = A[..., 0, 0], A[..., 0, 1], A[..., 1, 1]
        tr2 = 0.5 * (a00 + a11)
        d = jnp.sqrt(jnp.maximum((0.5 * (a00 - a11)) ** 2 + a01 * a01,
                                 0.0))
        w = jnp.stack([tr2 - d, tr2 + d], axis=-1)
        # eigenvector of w0: (A - w1 I) columns
        B = A - w[..., 1, None, None] * eye
        c0, c1 = B[..., :, 0], B[..., :, 1]
        pick = (jnp.sum(c0 * c0, -1, keepdims=True)
                >= jnp.sum(c1 * c1, -1, keepdims=True))
        v0 = jnp.where(pick, c0, c1)
        v0 = v0 / jnp.sqrt(jnp.maximum(
            jnp.sum(v0 * v0, -1, keepdims=True), 1e-38))
        v1 = jnp.stack([-v0[..., 1], v0[..., 0]], axis=-1)
        return w * scale[..., 0], jnp.stack([v0, v1], axis=-1)
    if n != 3:
        raise ValueError("sym_eigh_small supports n <= 3")
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    qm = (a00 + a11 + a22) / 3.0
    p2 = ((a00 - qm) ** 2 + (a11 - qm) ** 2 + (a22 - qm) ** 2
          + 2.0 * p1)
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 1e-38))
    B = (A - qm[..., None, None] * eye) / p[..., None, None]
    detB = (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2]
                            - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2]
                              - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1]
                              - B[..., 1, 1] * B[..., 2, 0]))
    r = jnp.clip(detB / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    w_hi = qm + 2.0 * p * jnp.cos(phi)
    w_lo = qm + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    w_mid = 3.0 * qm - w_hi - w_lo
    w = jnp.stack([w_lo, w_mid, w_hi], axis=-1)            # ascending

    def eigvec(wi, wj, wk):
        # v_i spans the column space of (A - wj I)(A - wk I)
        # (Cayley-Hamilton, rank one in exact arithmetic).  Select a
        # representative GATHER-FREE (no argmax/take_along_axis): the
        # image of almost any probe vector lies along v_i; use two fixed
        # non-parallel probes and keep the larger image elementwise.
        # Broadcast-sum matvecs, NOT `@`: millions of batched 3x3
        # dot_generals lower to padded contractions — computing
        # c = B1 (B2 u) elementwise removes the matmul entirely.
        B1 = A - wj[..., None, None] * eye
        B2 = A - wk[..., None, None] * eye
        u1 = jnp.asarray([1.0, 0.62, 0.29][:n], a.dtype)
        u2 = jnp.asarray([-0.33, 0.81, 1.0][:n], a.dtype)

        def image(u):
            b2u = jnp.sum(B2 * u, axis=-1)              # (..., n)
            return jnp.sum(B1 * b2u[..., None, :], axis=-1)

        c1 = image(u1)
        c2 = image(u2)
        n1 = jnp.sum(c1 * c1, -1, keepdims=True)
        n2 = jnp.sum(c2 * c2, -1, keepdims=True)
        v = jnp.where(n1 >= n2, c1, c2)
        return v / jnp.sqrt(jnp.maximum(
            jnp.sum(v * v, -1, keepdims=True), 1e-38))

    # candidates at the two spectral extremes; for (near-)repeated
    # eigenvalues the within-subspace direction is arbitrary (as for any
    # eigensolver), so complete to an ORTHONORMAL triple by anchoring on
    # the better-separated extreme, Gram-Schmidt-projecting the other,
    # and taking the cross product — exact reconstruction V diag(w) V'
    # holds then even for fully degenerate spectra (any orthonormal
    # basis is an eigenbasis there)
    v0c = eigvec(w[..., 0], w[..., 1], w[..., 2])
    v2c = eigvec(w[..., 2], w[..., 0], w[..., 1])
    low_sep = (w[..., 1] - w[..., 0]) >= (w[..., 2] - w[..., 1])
    anchor = jnp.where(low_sep[..., None], v0c, v2c)
    # exact-isotropic input: the Cayley-Hamilton products vanish exactly
    # and both candidates are zero — any orthonormal basis is an
    # eigenbasis, so seed with a fixed axis
    a2 = jnp.sum(anchor * anchor, -1, keepdims=True)
    anchor = jnp.where(a2 > 0.5, anchor,
                       jnp.broadcast_to(eye[2], anchor.shape))
    other = jnp.where(low_sep[..., None], v2c, v0c)
    other = other - jnp.sum(other * anchor, -1, keepdims=True) * anchor
    onorm = jnp.sqrt(jnp.maximum(
        jnp.sum(other * other, -1, keepdims=True), 1e-38))
    # if the secondary collapsed onto the anchor (isotropic case), fall
    # back to the anchor's least-aligned axis, re-projected
    fallback = eye[0] - anchor * anchor[..., 0:1]
    fb2 = eye[1] - anchor * anchor[..., 1:2]
    fa = jnp.where(jnp.abs(anchor[..., 0:1]) <= jnp.abs(anchor[..., 1:2]),
                   fallback, fb2)
    other = jnp.where(onorm > 1e-6, other / onorm,
                      fa / jnp.sqrt(jnp.maximum(
                          jnp.sum(fa * fa, -1, keepdims=True), 1e-38)))
    mid = jnp.cross(anchor, other)
    mid = mid / jnp.sqrt(jnp.maximum(
        jnp.sum(mid * mid, -1, keepdims=True), 1e-38))
    v0 = jnp.where(low_sep[..., None], anchor, other)
    v2 = jnp.where(low_sep[..., None], other, anchor)
    v = jnp.stack([v0, mid, v2], axis=-1)
    return w * scale[..., 0], v


def chol_small(a, floor=1e-12):
    r"""
    Closed-form lower Cholesky for trailing dims up to 5 (batched,
    elementwise ops only, unrolled at trace time).

    Correlation-normalized with a *relative* pivot floor: near-unit
    correlations otherwise cancel catastrophically in float32 (same
    stabilization as the fused kernels' packed-column factorization).
    A floored pivot corresponds to ~1e-6 relative noise injected along a
    genuinely degenerate direction.
    """
    n = a.shape[-1]
    tiny = jnp.asarray(jnp.finfo(a.dtype).tiny, a.dtype)
    d = jnp.sqrt(jnp.maximum(
        jnp.diagonal(a, axis1=-2, axis2=-1), tiny))           # (..., n)
    corr = a / (d[..., :, None] * d[..., None, :])
    L = [[None] * n for _ in range(n)]
    ok = [None] * n
    for i in range(n):
        for j in range(i + 1):
            s = corr[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                ok[i] = s > floor
                L[i][i] = jnp.sqrt(jnp.maximum(s, floor))
            else:
                # zero below floored pivots: the rank-deficient factor has
                # zeros there, and dividing cancellation noise by the
                # floored pivot otherwise blows up later columns ~1/floor
                L[i][j] = jnp.where(ok[j], s / L[j][j],
                                    jnp.zeros_like(s))
    rows = [jnp.stack(
        [L[i][j] if j <= i else jnp.zeros_like(corr[..., 0, 0])
         for j in range(n)], axis=-1) for i in range(n)]
    return jnp.stack(rows, axis=-2) * d[..., :, None]


def tri_solve_small(chol, b, lower=True, transpose=False):
    r"""
    Closed-form triangular solve by unrolled substitution for trailing
    dims up to 5 (batched; ``b`` is ``(..., n, k)``).  ``transpose=True``
    solves against ``chol.T`` (upper) without materializing it.
    """
    n = chol.shape[-1]
    if not lower:
        return tri_solve_small(jnp.swapaxes(chol, -1, -2), b,
                               lower=True, transpose=not transpose)
    cols = [b[..., i, :] for i in range(n)]
    out = [None] * n
    if not transpose:
        for i in range(n):
            s = cols[i]
            for k in range(i):
                s = s - chol[..., i, k, None] * out[k]
            out[i] = s / chol[..., i, i, None]
    else:
        for i in range(n - 1, -1, -1):
            s = cols[i]
            for k in range(i + 1, n):
                s = s - chol[..., k, i, None] * out[k]
            out[i] = s / chol[..., i, i, None]
    return jnp.stack(out, axis=-2)


def matmul_small(a, b):
    r"""
    Batched matrix product for tiny trailing dims via broadcast-multiply
    and sum — under :func:`fast_linalg` with both trailing dims <= 8.
    Tiny batched ``@`` lowers to a padded ``dot_general`` (and at default
    precision may run at reduced precision); the broadcast-sum form stays
    elementwise at full float32.  Falls back to ``@``.
    """
    if (_FAST.get() and a.shape[-1] <= 8 and a.shape[-2] <= 8
            and b.shape[-1] <= 8):
        return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)
    return a @ b
