r"""
Square-root (QR) form time-varying Kalman filtering and smoothing kernels.

Same state-space model and eight-function interface as
:mod:`rodeo_tpu.kalmantv.standard`, but all variance arguments and returns are
square-root factors :math:`\Gamma` with :math:`\Sigma = \Gamma \Gamma'`,
propagated via QR decompositions for numerical stability (important under
float32, where the standard form can lose positive-definiteness).

Functional parity target:
``/root/reference/src/rodeo/kalmantv/square_root.py``.

All kernels are batch polymorphic over leading dimensions (see
:mod:`rodeo_tpu.kalmantv.standard` for the rationale); batched QR and batched
triangular solves map onto single fused XLA ops.
"""
import jax
import jax.numpy as jnp

from rodeo_tpu.utils import add_sqrt, mtt, mvdot
from rodeo_tpu.ops.linalg import matmul_small as _mm
from rodeo_tpu.ops.linalg import full_matmul_precision

__all__ = [
    "predict",
    "update",
    "filter",
    "smooth_mv",
    "smooth_sim",
    "smooth",
    "forecast",
    "smooth_cond",
]


def _tri_solve(chol, b, lower=True):
    """Batched triangular solve ``chol^{-1} b`` on trailing matrix dims.

    Leading (batch) dims are broadcast explicitly —
    ``solve_triangular`` itself rejects mismatched batch ranks, which
    matters when a whole-time-axis batched kernel call mixes stacked
    ``(T, nb, q, q)`` factors with a shared ``(nb, q, q)`` transition.

    Under :func:`rodeo_tpu.ops.linalg.fast_linalg` (the preconditioned
    wrappers) tiny systems use unrolled closed-form substitution — the
    LAPACK-style batched triangular solve is an iterative routine that
    dominates the sqrt filter's step cost."""
    bshape = jnp.broadcast_shapes(chol.shape[:-2], b.shape[:-2])
    chol = jnp.broadcast_to(chol, bshape + chol.shape[-2:])
    b = jnp.broadcast_to(b, bshape + b.shape[-2:])
    from rodeo_tpu.ops.linalg import fast_linalg_enabled, tri_solve_small
    if fast_linalg_enabled() and chol.shape[-1] <= 5:
        return tri_solve_small(chol, b, lower=lower)
    return jax.scipy.linalg.solve_triangular(chol, b, lower=lower)


# --- core functions -----------------------------------------------------------


@full_matmul_precision
def predict(mean_state_past,
            var_state_past,
            mean_state,
            wgt_state,
            var_state,
            *args, **kwargs):
    r"""
    One prediction step of the square-root Kalman filter.

    Parity: ``square_root.py:30-58``.  ``var_state_past`` / ``var_state`` are
    square-root factors; the returned ``var_state_pred`` is the factor of
    :math:`Q \Sigma_{n-1|n-1} Q' + R`.
    """
    mean_state_pred = mvdot(wgt_state, mean_state_past) + mean_state
    var_state_pred = add_sqrt(_mm(wgt_state, var_state_past), var_state)
    return mean_state_pred, var_state_pred


@full_matmul_precision
def update(mean_state_pred,
           var_state_pred,
           x_meas,
           mean_meas,
           wgt_meas,
           var_meas,
           *args, **kwargs):
    r"""
    One update step of the square-root Kalman filter.

    Parity: ``square_root.py:61-101``.  Gain is obtained with two triangular
    solves against the forecast factor; the filtered factor is rebuilt with a
    QR of the joint innovation terms.
    """
    mean_meas_pred = mvdot(wgt_meas, mean_state_pred) + mean_meas
    # factor of the forecast variance S = W Sigma W' + V
    var_meas_meas_pred = add_sqrt(_mm(wgt_meas, var_state_pred), var_meas)
    # K = Sigma W' S^{-1} via L^{-T} (L^{-1} W) Sigma
    tmp = _tri_solve(var_meas_meas_pred, wgt_meas, lower=True)
    tmp = _mm(_mm(tmp, var_state_pred), mtt(var_state_pred))
    gain = mtt(_tri_solve(mtt(var_meas_meas_pred), tmp, lower=False))
    mean_state_filt = mean_state_pred + mvdot(gain, x_meas - mean_meas_pred)
    var_state_filt = add_sqrt(
        var_state_pred - _mm(_mm(gain, wgt_meas), var_state_pred),
        _mm(gain, var_meas),
    )
    return mean_state_filt, var_state_filt


@full_matmul_precision
def filter(mean_state_past,
           var_state_past,
           mean_state,
           wgt_state,
           var_state,
           x_meas,
           mean_meas,
           wgt_meas,
           var_meas,
           *args, **kwargs):
    r"""
    One full step of the square-root Kalman filter (:func:`predict` then
    :func:`update`).  Parity: ``square_root.py:104-155``.
    """
    mean_state_pred, var_state_pred = predict(
        mean_state_past=mean_state_past,
        var_state_past=var_state_past,
        mean_state=mean_state,
        wgt_state=wgt_state,
        var_state=var_state,
    )
    mean_state_filt, var_state_filt = update(
        mean_state_pred=mean_state_pred,
        var_state_pred=var_state_pred,
        x_meas=x_meas,
        mean_meas=mean_meas,
        wgt_meas=wgt_meas,
        var_meas=var_meas,
    )
    return mean_state_pred, var_state_pred, mean_state_filt, var_state_filt


def _smooth_gain(var_state_filt, var_state_pred, wgt_state):
    r"""
    Smoothing gain :math:`G_n = \Sigma_{n|n} Q' \Sigma_{n+1|n}^{-1}` computed
    from square-root factors with triangular solves.
    Parity: ``square_root.py:158-175``.
    """
    variance_state_filt = _mm(var_state_filt, mtt(var_state_filt))
    tmp = _tri_solve(var_state_pred, wgt_state, lower=True)
    tmp = _mm(tmp, variance_state_filt)
    gain = mtt(_tri_solve(mtt(var_state_pred), tmp, lower=False))
    return gain


def _joint_sqrt(gain, wgt_state, var_state_filt, extra_sqrt):
    r"""
    Square-root factor of ``G X G' + (I - G Q) Sigma_filt (I - G Q)'`` where
    ``X`` is given by its factor ``extra_sqrt`` (possibly rectangular).
    Implements the ``J = I - G Q`` construction of ``square_root.py:215-218``.
    """
    eye = jnp.broadcast_to(
        jnp.eye(gain.shape[-1], dtype=gain.dtype), gain.shape)
    J = eye - _mm(gain, wgt_state)
    return add_sqrt(_mm(gain, extra_sqrt), _mm(J, var_state_filt))


@full_matmul_precision
def smooth_mv(mean_state_next,
              var_state_next,
              mean_state_filt,
              var_state_filt,
              mean_state_pred,
              var_state_pred,
              wgt_state,
              var_state,
              *args, **kwargs):
    r"""
    One step of the square-root mean/variance smoother.

    Parity: ``square_root.py:178-219``.  Note the extra ``var_state``
    argument (process-noise factor) relative to the standard form.
    """
    gain = _smooth_gain(var_state_filt, var_state_pred, wgt_state)
    mean_state_smooth = mean_state_filt + mvdot(
        gain, mean_state_next - mean_state_pred)
    var_state_smooth = _joint_sqrt(
        gain, wgt_state, var_state_filt,
        jnp.concatenate([var_state_next, var_state], axis=-1),
    )
    return mean_state_smooth, var_state_smooth


@full_matmul_precision
def smooth_sim(x_state_next,
               mean_state_filt,
               var_state_filt,
               mean_state_pred,
               var_state_pred,
               wgt_state,
               var_state,
               *args, **kwargs):
    r"""
    One step of the square-root sampling smoother.

    Parity: ``square_root.py:222-261``.
    """
    gain = _smooth_gain(var_state_filt, var_state_pred, wgt_state)
    mean_state_sim = mean_state_filt + mvdot(
        gain, x_state_next - mean_state_pred)
    var_state_sim = _joint_sqrt(gain, wgt_state, var_state_filt, var_state)
    return mean_state_sim, var_state_sim


@full_matmul_precision
def smooth(x_state_next,
           mean_state_next,
           var_state_next,
           mean_state_filt,
           var_state_filt,
           mean_state_pred,
           var_state_pred,
           wgt_state,
           var_state,
           *args, **kwargs):
    r"""
    Fused square-root mean/variance and sampling smoother step.

    Parity: ``square_root.py:264-314``.
    """
    gain = _smooth_gain(var_state_filt, var_state_pred, wgt_state)
    mean_state_sim = mean_state_filt + mvdot(
        gain, x_state_next - mean_state_pred)
    mean_state_smooth = mean_state_filt + mvdot(
        gain, mean_state_next - mean_state_pred)
    var_state_sim = _joint_sqrt(gain, wgt_state, var_state_filt, var_state)
    var_state_smooth = _joint_sqrt(
        gain, wgt_state, var_state_filt,
        jnp.concatenate([var_state_next, var_state], axis=-1),
    )
    return mean_state_sim, var_state_sim, mean_state_smooth, var_state_smooth


@full_matmul_precision
def forecast(mean_state_pred,
             var_state_pred,
             mean_meas,
             wgt_meas,
             var_meas,
             *args, **kwargs):
    r"""
    Measurement forecast distribution.

    Parity: ``square_root.py:317-345``.  NOTE: like the reference, the
    returned ``var_fore`` is the **full** variance :math:`L L'` (not a
    factor), so that logpdf consumers are form-agnostic.
    """
    mean_fore = mvdot(wgt_meas, mean_state_pred) + mean_meas
    var_fore = add_sqrt(_mm(wgt_meas, var_state_pred), var_meas)
    var_fore = _mm(var_fore, mtt(var_fore))
    return mean_fore, var_fore


@full_matmul_precision
def smooth_cond(mean_state_filt,
                var_state_filt,
                mean_state_pred,
                var_state_pred,
                wgt_state,
                var_state,
                *args, **kwargs):
    r"""
    Backward Markov-kernel parameters in square-root form.

    Finds :math:`A_n`, :math:`b_n`, and a factor :math:`C_n` of :math:`V_n`
    such that :math:`X_n \mid X_{n+1} \sim N(A_n X_{n+1} + b_n, V_n)`.
    Parity: ``square_root.py:348-385``.
    """
    gain = _smooth_gain(var_state_filt, var_state_pred, wgt_state)
    mean_state_cond = mean_state_filt - mvdot(gain, mean_state_pred)
    var_state_cond = _joint_sqrt(gain, wgt_state, var_state_filt, var_state)
    return gain, mean_state_cond, var_state_cond
