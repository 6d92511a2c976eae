r"""
Basic (plug-in) likelihood approximation.

Computes :math:`\log p(Y_{0:M} \mid Z_{1:N})` by plugging the smoothed
posterior mean :math:`\mu_{0:N|N}` of the ODE solution into a user-supplied
observation log-likelihood:

.. math::

    \log p(Y_{0:M} \mid Z_{1:N}) \approx
      \sum_{i=0}^M \log p(Y_i \mid X_{n(i)} = \mu_{n(i)|N}),

matching observation times to the closest solver grid point.

Functional parity target: ``/root/reference/src/rodeo/inference/basic.py``.

.. admonition:: float32 on chaotic systems — use fenrir/dalton instead

   The plug-in construction evaluates the smoothed mean POINTWISE at the
   observation times.  On a chaotic ODE every float32 trajectory diverges
   from the float64 one at late times (positive Lyapunov exponent
   amplifies ULP-level rounding to O(attractor) separation), so the
   plug-in likelihood inherits that divergence wholesale: on the
   Lorenz63 bench config (4k grid, t in [0, 20]) ``basic`` lands ~12%
   relative off its f64 value — and the SAME pipeline run in f32 on CPU
   lands ~11.7% off (the ``basic_f32cpu_control_rel_err`` bench row),
   i.e. this is the f32 floor of plug-in-on-chaotic, not a device defect.
   The error is inherent to the method: no solver change can help,
   because the information that distinguishes f32 from f64 trajectories
   is below f32 resolution.  Two mitigations:

   * prefer :func:`rodeo_tpu.inference.fenrir` / ``dalton`` for
     parameter inference on chaotic systems — they marginalize over the
     posterior path rather than plugging in its mean, and measure at
     1e-5 / 1e-7 relative on the identical f32 config;
   * on non-chaotic systems ``basic`` is fine in f32: the same pipeline
     on FitzHugh–Nagumo sits at the ordinary f32 rounding floor (the
     ``basic_fitz`` bench row and
     ``tests/test_inference_oracle.py::test_basic_f32_floor_non_chaotic``).
"""
import jax
import jax.numpy as jnp

from rodeo_tpu.solve import solve_mv
from rodeo_tpu.ops.linalg import full_matmul_precision

__all__ = ["basic"]


@full_matmul_precision
def basic(key, ode_fun, ode_weight, ode_init,
          t_min, t_max, n_steps,
          interrogate,
          prior_pars,
          obs_data, obs_times, obs_loglik,
          kalman_type="standard", temporal="sequential", **params):
    r"""
    Basic approximate log-likelihood of :math:`p(Y_{0:M} \mid Z_{1:N})`.

    Args:
        key (PRNGKey): PRNG key.
        ode_fun (Callable): Block-form ODE function.
        ode_weight (ndarray(n_block, n_bmeas, n_bstate)): :math:`W`.
        ode_init (ndarray(n_block, n_bstate)): Initial state.
        t_min, t_max (float): Solution interval.
        n_steps (int): Number of solver steps.
        interrogate (Callable): Interrogation scheme.
        prior_pars (tuple): ``(prior_weight, prior_var)``.
        obs_data (ndarray(n_obs, n_bobs)): Observations.
        obs_times (ndarray(n_obs)): Observation times.
        obs_loglik (Callable): ``obs_loglik(obs_data, ode_data, **params)``.
        kalman_type (str): ``"standard"`` or ``"square-root"``.
        temporal (str): ``"sequential"`` or ``"parallel"`` — the latter
            runs the underlying smoother parallel-in-time
            (:mod:`rodeo_tpu.ops.ptime`); an addition to the reference, values
            identical.  For lane-batched throughput use
            :func:`rodeo_tpu.ops.pallas_kalman.basic_fused_batch`.
        params: Optional model parameters.

    Returns:
        (tuple): the log-likelihood value and the smoothed solution ``Xt``.
    """
    Xt, _ = solve_mv(
        key=key,
        ode_fun=ode_fun,
        ode_weight=ode_weight,
        ode_init=ode_init,
        t_min=t_min,
        t_max=t_max,
        n_steps=n_steps,
        interrogate=interrogate,
        prior_pars=prior_pars,
        kalman_type=kalman_type,
        temporal=temporal,
        **params,
    )
    sim_times = jnp.linspace(t_min, t_max, n_steps + 1)
    ode_data = Xt[jnp.searchsorted(sim_times, obs_times)]
    return obs_loglik(obs_data, ode_data, **params), Xt
