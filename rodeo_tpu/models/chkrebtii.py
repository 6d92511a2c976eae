r"""
Chkrebtii second-order ODE (reference JSS preprint Table 3 benchmark;
``/root/reference/examples/timings.py:104-169``):

.. math::

    \ddot x = \sin(2 t) - x, \qquad x(0) = -1, \ \dot x(0) = 0,

solved with one block and ``n_deriv = 4`` (the ``d \cdot p = 4``
higher-order configuration; the ODE weight selects the SECOND derivative,
``W = [0, 0, 1, 0]``).
"""
import jax
import jax.numpy as jnp

from rodeo_tpu.prior import ibm_init

__all__ = ["chkrebtii_fun", "chkrebtii_flat", "chkrebtii_jac_flat", "setup"]

N_VARS = 1
N_DERIV = 4


def chkrebtii_fun(X_t, t, **params):
    """Chkrebtii ODE in block form: ``X_t`` is ``(1, n_deriv)``."""
    return jnp.array([[jnp.sin(2 * t) - X_t[0, 0]]])


def chkrebtii_flat(x_cols, th, t):
    """Chkrebtii right-hand side (see
    :func:`rodeo_tpu.models.lorenz.lorenz_flat` for the contract)."""
    del th
    x = x_cols[0]                                  # (1, B) position column
    return jnp.sin(2.0 * t) - x


def chkrebtii_jac_flat(x_cols, th, t):
    """Block-diagonal Jacobian columns: ``d f / d x = -1``."""
    del th, t
    x = x_cols[0]
    return [jnp.zeros_like(x) - 1.0] + [None] * (N_DERIV - 1)


def setup(n_steps=30, t_min=0.0, t_max=10.0, prior_sigma=0.1,
          dtype=jnp.float64):
    """Solver configuration for the Chkrebtii benchmark
    (``timings.py:121-140``)."""
    W = jnp.zeros((N_VARS, 1, N_DERIV), dtype=dtype).at[:, :, 2].set(1.0)
    x0 = jnp.array([[-1.0, 0.0, 1.0, 0.0]], dtype=dtype)
    dt = (t_max - t_min) / n_steps
    prior_pars = ibm_init(dt, N_DERIV, jnp.array([prior_sigma] * N_VARS,
                                                 dtype=dtype))
    return dict(
        ode_fun=chkrebtii_fun,
        ode_weight=W,
        ode_init=x0,
        theta=None,
        t_min=t_min, t_max=t_max, n_steps=n_steps,
        prior_pars=jax.tree_util.tree_map(
            lambda a: a.astype(dtype), prior_pars),
    )
