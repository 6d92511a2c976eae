r"""
Utility functions for rodeo-tpu.

This module provides the numerical-linear-algebra building blocks shared by
the Kalman kernels and the inference layer.  Functional parity targets:
``/root/reference/src/rodeo/utils.py`` (``add_sqrt``, ``mvncond``,
``multivariate_normal_logpdf``, ``first_order_pad``, ``solve_var``).

Design notes
------------
Every function here is *batch polymorphic*: matrix arguments may carry an
arbitrary number of leading batch dimensions (e.g. the ``n_block`` axis of the
block-diagonal solver state, or a chain axis for vmapped MCMC).  All matrix
algebra is expressed with broadcasting ``@`` / ``einsum`` / batched
``qr``/``eigh`` so that a single XLA op covers the whole batch instead of a
per-block ``vmap`` loop.  That keeps the ops large and fusable.
"""
import jax
import jax.numpy as jnp
import jax.scipy as jsp

__all__ = [
    "add_sqrt",
    "mvncond",
    "multivariate_normal_logpdf",
    "first_order_pad",
    "solve_var",
    "mtt",
    "mvdot",
    "quadform",
]


def mtt(mat):
    """Matrix transpose on the trailing two dimensions (batch friendly)."""
    return jnp.swapaxes(mat, -1, -2)


def mvdot(mat, vec):
    """Batched matrix-vector product on trailing dims: ``mat @ vec``."""
    return jnp.einsum("...ij,...j->...i", mat, vec)


def quadform(wgt, var):
    """Batched quadratic form ``wgt @ var @ wgt.T`` on trailing dims."""
    return jnp.einsum("...ij,...jk,...lk->...il", wgt, var, wgt)


def add_sqrt(sqrt_A, sqrt_B):
    r"""
    Square root of a sum of matrices given their square roots.

    Given factors :math:`A^{1/2}` and :math:`B^{1/2}` (in the sense
    :math:`A = A^{1/2} (A^{1/2})'`), returns a lower-triangular-ish factor
    :math:`L` with :math:`L L' = A + B` via the QR decomposition of the
    stacked transposed factors.  Matches the construction of the reference
    (``utils.py:10-24``) so that downstream :math:`L L'` values agree.

    Args:
        sqrt_A (ndarray(..., n, m_a)): Square root factor of ``A``; ``m_a >= 0``.
        sqrt_B (ndarray(..., n, m_b)): Square root factor of ``B``.

    Returns:
        (ndarray(..., n, n)): Factor ``L`` such that ``L @ L.T = A + B``.
    """
    n = sqrt_A.shape[-2]
    from rodeo_tpu.ops.linalg import fast_linalg_enabled
    if fast_linalg_enabled() and n <= 5:
        # fast path: closed-form Cholesky of the Gram sum A A' + B B'.
        # A valid factor (differs from the QR one by an orthogonal
        # rotation only, so every L L' consumer agrees); forming the Gram
        # squares the condition number, which the Taylor-preconditioned
        # wrappers — the only fast_linalg users — keep at O(1).  Batched
        # QR is an iterative routine of many times the cost.
        from rodeo_tpu.ops.linalg import chol_small
        # broadcast-sum Gram: tiny batched `@` lowers to a padded
        # dot_general; the elementwise form stays elementwise
        gram = (sqrt_A[..., :, None, :] * sqrt_A[..., None, :, :]
                ).sum(-1) + \
               (sqrt_B[..., :, None, :] * sqrt_B[..., None, :, :]).sum(-1)
        return chol_small(gram)
    stacked = jnp.concatenate([mtt(sqrt_A), mtt(sqrt_B)], axis=-2)
    _, r = jnp.linalg.qr(stacked, mode="reduced")
    return mtt(r)


def solve_var(V, B):
    r"""
    Computes :math:`X = V^{-1} B` for a variance (symmetric PD) matrix ``V``.

    Batched over leading dimensions.  Parity: ``utils.py:105-119``.
    Under the :func:`rodeo_tpu.ops.linalg.fast_linalg` context (enabled by
    the Taylor-preconditioned solvers), tiny systems use closed forms and
    large systems Cholesky + triangular solves instead of the general
    batched LU (see :func:`rodeo_tpu.ops.linalg.solve_psd`).

    .. note:: behavior change vs earlier revisions: ``V`` must be
       symmetric PD under ``fast_linalg`` with ``n > 5`` — a numerically
       indefinite ``V`` yields NaN from the Cholesky where a general LU
       would return finite (garbage) values.  All in-library callers pass
       PD variances (the one known non-PD site, fenrir's backward
       smoothing, avoids ``fast_linalg``); third-party callers with
       possibly-indefinite inputs should use ``jnp.linalg.solve``
       directly.
    """
    from rodeo_tpu.ops.linalg import solve_psd
    return solve_psd(V, B)


def mvncond(mu, Sigma, icond):
    r"""
    Gaussian conditional parameters.

    For :math:`y \sim N(\mu, \Sigma)`, calculates ``A``, ``b``, ``V`` such
    that :math:`y[\neg icond] \mid y[icond] \sim N(A\, y[icond] + b, V)`.
    Parity: ``utils.py:27-57``.

    Args:
        mu (ndarray(n)): Mean of ``y``.
        Sigma (ndarray(n, n)): Covariance of ``y``.
        icond (ndarray(n) of bool): Which entries are conditioned on.

    Returns:
        (tuple): ``A`` (n1, n2), ``b`` (n1,), ``V`` (n1, n1) with
        ``n2 = sum(icond)``, ``n1 = n - n2``.
    """
    free_idx = jnp.nonzero(~icond)[0]
    cond_idx = jnp.nonzero(icond)[0]
    S12 = Sigma[jnp.ix_(free_idx, cond_idx)]
    S22 = Sigma[jnp.ix_(cond_idx, cond_idx)]
    S21 = Sigma[jnp.ix_(cond_idx, free_idx)]
    S11 = Sigma[jnp.ix_(free_idx, free_idx)]
    A = jnp.dot(S12, solve_var(S22, jnp.identity(S22.shape[0])))
    b = mu[~icond] - jnp.dot(A, mu[icond])
    V = S11 - jnp.dot(A, S21)
    return A, b, V


def _mvn_logpdf_pieces(x, mean, cov):
    """Shared primal quantities for the masked-eigen logpdf and its JVP."""
    w, v = jnp.linalg.eigh(cov)
    rel_tol = 100.0 * jnp.finfo(cov.dtype).eps
    rel_live = None
    if cov.shape[-1] == 2:
        # for a widely-split 2x2 spectrum eigh's small eigenvalue carries
        # ~eps*lam_hi ABSOLUTE error (the eigenvectors are fine — their
        # conditioning goes with the gap, which is large): a true 1e-10
        # next to a 1.0 comes back as 0 +- 1e-7 in float32.  lam_lo =
        # det/lam_hi recovers it to the relative accuracy of det itself,
        # and `det > rel_tol * (v00*v11 + v01^2)` is a direct significance
        # test of that computation — the direction is LIVE iff the
        # determinant is resolvable above its own rounding noise.  This
        # replaces the generic `w > rel_tol * wmax` screen, which in f32
        # mis-masks genuine directions at spectral splits beyond ~1e5:
        # stacked DALTON forecasts (diffuse ODE row + observation row,
        # split ~2e5) lost half their live directions that way — measured
        # +264 log-density drift on Lorenz63-4k from the masking alone,
        # vs -31 from the f32 entry noise this test correctly keeps.
        det = (cov[..., 0, 0] * cov[..., 1, 1]
               - cov[..., 0, 1] * cov[..., 1, 0])
        noise_mag = (cov[..., 0, 0] * cov[..., 1, 1]
                     + cov[..., 0, 1] * cov[..., 1, 0])
        hi = w[..., 1]
        lo = jnp.where(hi != 0, det / jnp.where(hi == 0, 1.0, hi),
                       w[..., 0])
        w = jnp.stack([lo, hi], axis=-1)
        wmax_2 = jnp.abs(hi)
        rel_live = jnp.stack(
            [det > rel_tol * noise_mag, hi > rel_tol * wmax_2], axis=-1)
    z = mvdot(mtt(v), x - mean)
    # degenerate-direction mask: absolute (reference semantics,
    # ``utils.py:71-77``) AND dtype-relative — eigh of a PSD-up-to-rounding
    # matrix returns eigenvalues negative at ~eps * ||cov||, which for
    # large-scale covariances (e.g. diffuse priors in float32) far exceeds
    # any absolute threshold and would NaN through log().
    if rel_live is None:
        wmax = jnp.max(jnp.abs(w), axis=-1, keepdims=True)
        rel_live = w > rel_tol * wmax
    live = (~jnp.isclose(w, 0.0, rtol=1e-300)) & rel_live
    w_safe = jnp.where(live, w, 1.0)
    val = z * z / w_safe + jnp.log(w_safe)
    val = -0.5 * jnp.sum(jnp.where(live, val, 0.0), axis=-1)
    val = val - 0.5 * jnp.log(2 * jnp.pi) * jnp.sum(live, axis=-1)
    return val, (w, v, z, live, w_safe)


@jax.custom_jvp
def multivariate_normal_logpdf(x, mean, cov):
    r"""
    Log-density of a (possibly singular) multivariate normal.

    Uses an eigendecomposition and masks (near-)zero eigenvalues, so that
    degenerate directions contribute neither to the quadratic form nor to the
    normalizing constant.  Parity: ``utils.py:60-78``.

    Batched over leading dims of ``x``/``mean``/``cov``.

    Differentiation note: the derivative is supplied analytically in terms
    of the masked pseudo-inverse (constant-rank semantics: the null space
    is treated as structural).  ``jnp.linalg.eigh``'s own JVP divides by
    eigenvalue gaps and returns NaN on the *repeated* eigenvalues that
    masked stacked covariances always carry (e.g. the unit dead-row blocks
    of the DALTON forecast), which made ``jax.grad`` of every
    logpdf-consuming likelihood NaN.

    Args:
        x (ndarray(..., p)): Observation.
        mean (ndarray(..., p)): Mean.
        cov (ndarray(..., p, p)): Symmetric PSD covariance.

    Returns:
        (ndarray(...)): Log-density value(s).
    """
    val, _ = _mvn_logpdf_pieces(x, mean, cov)
    return val


@multivariate_normal_logpdf.defjvp
def _mvn_logpdf_jvp(primals, tangents):
    # d logpdf = -1/2 [ 2 a'·v'(dx-dmean) − a'Ma + tr(Σ⁺ dΣ) ],
    # a = Σ⁺(x−mean) in the eigenbasis, M = v' dΣ v,
    # tr(Σ⁺dΣ) = Σ_live M_ii/w_i — exact for locally constant rank.
    x, mean, cov = primals
    dx, dmean, dcov = tangents
    val, (w, v, z, live, w_safe) = _mvn_logpdf_pieces(x, mean, cov)
    alpha = jnp.where(live, z / w_safe, 0.0)
    dz = mvdot(mtt(v), dx - dmean)
    term1 = 2.0 * jnp.sum(alpha * dz, axis=-1)
    Mv = jnp.matmul(jnp.matmul(mtt(v), dcov), v)
    term2 = -jnp.einsum("...i,...ij,...j->...", alpha, Mv, alpha)
    Mdiag = jnp.diagonal(Mv, axis1=-2, axis2=-1)
    term3 = jnp.sum(jnp.where(live, Mdiag / w_safe, 0.0), axis=-1)
    return val, -0.5 * (term1 + term2 + term3)


def first_order_pad(ode_fun, n_vars, n_deriv):
    r"""
    Build the ODE weight matrix ``W`` and an initial-state padding function
    for a first-order ODE system lifted to ``n_deriv`` derivatives.

    Parity: ``utils.py:80-102``.

    Args:
        ode_fun (Callable): Block-form ODE function ``f(X, t, **params)``.
        n_vars (int): Number of ODE variables (blocks).
        n_deriv (int): Number of derivatives per block in the solver state.

    Returns:
        (tuple):
        - **W** (ndarray(n_vars, 1, n_deriv)): ODE weight matrix selecting the
          first derivative of each block.
        - **ode_init** (Callable): ``ode_init(x0, t, **params)`` returning the
          zero-padded initial state of shape ``(n_vars, n_deriv)``.
    """

    def ode_init(x0, t, **params):
        x0 = x0[:, None]
        return jnp.hstack(
            [x0, ode_fun(x0, t, **params), jnp.zeros((n_vars, n_deriv - 2))]
        )

    W = jnp.zeros((n_vars, 1, n_deriv))
    W = W.at[:, :, 1].set(1.0)
    return W, ode_init
