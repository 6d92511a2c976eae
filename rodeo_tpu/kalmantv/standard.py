r"""
Covariance-form time-varying Kalman filtering and smoothing kernels.

The Gaussian state-space model underlying the algorithms is

.. math::

    x_n = c_n + Q_n x_{n-1} + R_n^{1/2} \epsilon_n

    y_n = d_n + W_n x_n + V_n^{1/2} \eta_n,

with iid standard-normal noise.  The kernels compute
:math:`\theta_{m|n} = (\mu_{m|n}, \Sigma_{m|n})` for various :math:`m, n`.

Functional parity target: ``/root/reference/src/rodeo/kalmantv/standard.py``
(same eight public function names with compatible keyword signatures:
``predict``, ``update``, ``filter``, ``smooth_mv``, ``smooth_sim``,
``smooth``, ``forecast``, ``smooth_cond``).

Design
------
Unlike the reference (which operates on a single block and is ``jax.vmap``-ed
by every caller), every kernel here is **batch polymorphic**: all matrix /
vector arguments accept arbitrary leading batch dimensions (block, chain,
time-tile, ...).  The math is expressed with broadcasting ``@`` / ``einsum``
and batched ``jnp.linalg.solve``, so a single call covers the whole stacked
``(n_block, q, q)`` state in one fused XLA computation — larger ops, no
vmap plumbing.  ``jax.vmap`` of these kernels still works and returns
identical results, so reference-style call sites remain valid.
"""
import jax
import jax.numpy as jnp

from rodeo_tpu.utils import mtt, mvdot, quadform, solve_var
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


# --- core functions -----------------------------------------------------------


@full_matmul_precision
def predict(mean_state_past,
            var_state_past,
            mean_state,
            wgt_state,
            var_state,
            *args, **kwargs):
    r"""
    One prediction step of the Kalman filter.

    Computes the mean and variance of :math:`p(X_n \mid Z_{0:n-1})` from
    :math:`p(X_{n-1} \mid Z_{0:n-1})`.  Parity: ``standard.py:31-60``.

    Args:
        mean_state_past (ndarray(..., n_state)): :math:`\mu_{n-1|n-1}`.
        var_state_past (ndarray(..., n_state, n_state)): :math:`\Sigma_{n-1|n-1}`.
        mean_state (ndarray(..., n_state)): State offset :math:`c_n`.
        wgt_state (ndarray(..., n_state, n_state)): Transition :math:`Q_n`.
        var_state (ndarray(..., n_state, n_state)): Process noise :math:`R_n`.

    Returns:
        (tuple): ``mean_state_pred`` :math:`\mu_{n|n-1}` and
        ``var_state_pred`` :math:`\Sigma_{n|n-1}`.
    """
    mean_state_pred = mvdot(wgt_state, mean_state_past) + mean_state
    var_state_pred = quadform(wgt_state, var_state_past) + var_state
    return mean_state_pred, var_state_pred


@full_matmul_precision
def update(mean_state_pred,
           var_state_pred,
           x_meas,
           mean_meas,
           wgt_meas,
           var_meas,
           *args, joseph=None, **kwargs):
    r"""
    One update step of the Kalman filter.

    Computes the mean and variance of :math:`p(X_n \mid Z_{0:n})` from
    :math:`p(X_n \mid Z_{0:n-1})`.  Parity: ``standard.py:63-103``.

    Args:
        mean_state_pred (ndarray(..., n_state)): :math:`\mu_{n|n-1}`.
        var_state_pred (ndarray(..., n_state, n_state)): :math:`\Sigma_{n|n-1}`.
        x_meas (ndarray(..., n_meas)): Measurement :math:`y_n`.
        mean_meas (ndarray(..., n_meas)): Measurement offset :math:`d_n`.
        wgt_meas (ndarray(..., n_meas, n_state)): Measurement matrix :math:`W_n`.
        var_meas (ndarray(..., n_meas, n_meas)): Measurement noise :math:`V_n`.
        joseph (bool | None): Force the Joseph-stabilized covariance update
            on (True) or off (False); ``None`` defers to
            ``fast_linalg_enabled()``.  Exact-arithmetic identical either
            way; Joseph preserves PSD under cancellation (essential for
            exact/zero-noise pseudo-measurements, where the subtractive
            form drifts indefinite — see the MAGI oracle test).

    Returns:
        (tuple): ``mean_state_filt`` :math:`\mu_{n|n}` and
        ``var_state_filt`` :math:`\Sigma_{n|n}`.
    """
    mean_meas_pred = mvdot(wgt_meas, mean_state_pred) + mean_meas
    var_meas_state_pred = wgt_meas @ var_state_pred
    var_meas_meas_pred = quadform(wgt_meas, var_state_pred) + var_meas
    # Kalman gain K = Sigma W' S^{-1} = (S^{-1} W Sigma)'
    gain = mtt(solve_var(var_meas_meas_pred, var_meas_state_pred))
    mean_state_filt = mean_state_pred + mvdot(gain, x_meas - mean_meas_pred)
    if joseph is None:
        from rodeo_tpu.ops.linalg import fast_linalg_enabled
        joseph = fast_linalg_enabled()
    if joseph:
        # Joseph-stabilized covariance update: PSD-preserving under
        # float32 cancellation (essential for exact/zero-noise
        # pseudo-measurements on the fast path)
        eye = jnp.broadcast_to(
            jnp.eye(var_state_pred.shape[-1], dtype=var_state_pred.dtype),
            var_state_pred.shape)
        ikw = eye - gain @ wgt_meas
        var_state_filt = quadform(ikw, var_state_pred) + \
            quadform(gain, var_meas)
    else:
        var_state_filt = var_state_pred - gain @ var_meas_state_pred
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
    One full step of the Kalman filter: :func:`predict` then :func:`update`.

    Parity: ``standard.py:106-157``.

    Returns:
        (tuple): ``mean_state_pred``, ``var_state_pred``,
        ``mean_state_filt``, ``var_state_filt``.
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
    Shared smoother computation.

    Returns ``var_state_temp = Sigma_{n|n} Q'`` and the smoothing gain
    ``G_n = Sigma_{n|n} Q' Sigma_{n+1|n}^{-1}``.  Parity: ``standard.py:160-177``.
    """
    var_state_temp = var_state_filt @ mtt(wgt_state)
    gain = mtt(solve_var(var_state_pred, mtt(var_state_temp)))
    return var_state_temp, gain


@full_matmul_precision
def smooth_mv(mean_state_next,
              var_state_next,
              mean_state_filt,
              var_state_filt,
              mean_state_pred,
              var_state_pred,
              wgt_state,
              *args, **kwargs):
    r"""
    One step of the Kalman (RTS) mean/variance smoother.

    Computes the mean and variance of :math:`p(X_n \mid Z_{0:N})`.
    Parity: ``standard.py:180-217``.

    Returns:
        (tuple): ``mean_state_smooth`` :math:`\mu_{n|N}` and
        ``var_state_smooth`` :math:`\Sigma_{n|N}`.
    """
    _, gain = _smooth_gain(var_state_filt, var_state_pred, wgt_state)
    mean_state_smooth = mean_state_filt + mvdot(
        gain, mean_state_next - mean_state_pred)
    var_state_smooth = var_state_filt + quadform(
        gain, var_state_next - var_state_pred)
    return mean_state_smooth, var_state_smooth


@full_matmul_precision
def smooth_sim(x_state_next,
               mean_state_filt,
               var_state_filt,
               mean_state_pred,
               var_state_pred,
               wgt_state,
               *args, **kwargs):
    r"""
    One step of the Kalman sampling smoother.

    Computes the mean and variance of
    :math:`p(X_n \mid X_{n+1}, Z_{0:N})`.  Parity: ``standard.py:220-255``.

    Returns:
        (tuple): ``mean_state_sim`` and ``var_state_sim``.
    """
    var_state_temp, gain = _smooth_gain(
        var_state_filt, var_state_pred, wgt_state)
    mean_state_sim = mean_state_filt + mvdot(
        gain, x_state_next - mean_state_pred)
    var_state_sim = _sim_var(gain, var_state_temp, var_state_filt,
                             wgt_state, kwargs.get("var_state"))
    return mean_state_sim, var_state_sim


def _sim_var(gain, var_state_temp, var_state_filt, wgt_state, var_state):
    r"""Sampling-smoother conditional variance
    :math:`\Sigma_{n|n} - G_n \Sigma_{n+1|n} G_n'`.  On the fast-linalg
    path (and when the process noise is available) it is computed in the
    algebraically equal Joseph form
    :math:`(I - G Q)\Sigma_{n|n}(I - G Q)' + G R G'`, which stays PSD
    under float32 cancellation (the subtraction form goes indefinite and
    NaNs downstream log-densities)."""
    from rodeo_tpu.ops.linalg import fast_linalg_enabled
    if fast_linalg_enabled() and var_state is not None:
        eye = jnp.broadcast_to(
            jnp.eye(var_state_filt.shape[-1], dtype=var_state_filt.dtype),
            var_state_filt.shape)
        igq = eye - gain @ wgt_state
        return quadform(igq, var_state_filt) + quadform(gain, var_state)
    return var_state_filt - gain @ mtt(var_state_temp)


@full_matmul_precision
def smooth(x_state_next,
           mean_state_next,
           var_state_next,
           mean_state_filt,
           var_state_filt,
           mean_state_pred,
           var_state_pred,
           wgt_state,
           *args, **kwargs):
    r"""
    Fused mean/variance and sampling smoother step.

    Parity: ``standard.py:258-305``.

    Returns:
        (tuple): ``mean_state_sim``, ``var_state_sim``,
        ``mean_state_smooth``, ``var_state_smooth``.
    """
    var_state_temp, gain = _smooth_gain(
        var_state_filt, var_state_pred, wgt_state)
    mean_state_sim = mean_state_filt + mvdot(
        gain, x_state_next - mean_state_pred)
    var_state_sim = _sim_var(gain, var_state_temp, var_state_filt,
                             wgt_state, kwargs.get("var_state"))
    mean_state_smooth = mean_state_filt + mvdot(
        gain, mean_state_next - mean_state_pred)
    var_state_smooth = var_state_filt + quadform(
        gain, var_state_next - var_state_pred)
    return mean_state_sim, var_state_sim, mean_state_smooth, var_state_smooth


@full_matmul_precision
def forecast(mean_state_pred,
             var_state_pred,
             mean_meas,
             wgt_meas,
             var_meas,
             *args, **kwargs):
    r"""
    Measurement predictive (forecast) distribution at time :math:`n` given
    observations :math:`0, \dots, n-1`.  Parity: ``standard.py:308-336``.

    Returns:
        (tuple): ``mean_fore`` and ``var_fore`` of the measurement.
    """
    mean_fore = mvdot(wgt_meas, mean_state_pred) + mean_meas
    var_fore = quadform(wgt_meas, var_state_pred) + var_meas
    return mean_fore, var_fore


@full_matmul_precision
def smooth_cond(mean_state_filt,
                var_state_filt,
                mean_state_pred,
                var_state_pred,
                wgt_state,
                *args, **kwargs):
    r"""
    Backward Markov-kernel parameters of the smoothing pass.

    Finds :math:`A_n`, :math:`b_n`, :math:`V_n` such that
    :math:`X_n \mid X_{n+1}, Z_{0:n} \sim N(A_n X_{n+1} + b_n, V_n)`.
    Parity: ``standard.py:339-371``.

    Returns:
        (tuple): ``wgt_state_cond`` :math:`A_n`, ``mean_state_cond``
        :math:`b_n`, ``var_state_cond`` :math:`V_n`.
    """
    var_state_temp, gain = _smooth_gain(
        var_state_filt, var_state_pred, wgt_state)
    mean_state_cond = mean_state_filt - mvdot(gain, mean_state_pred)
    # same PSD-stable Joseph form as the sampling smoother (f32 safety;
    # algebraically equal to the subtraction form)
    var_state_cond = _sim_var(gain, var_state_temp, var_state_filt,
                              wgt_state, kwargs.get("var_state"))
    return gain, mean_state_cond, var_state_cond
