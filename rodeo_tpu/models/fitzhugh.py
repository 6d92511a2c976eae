r"""
FitzHugh-Nagumo neuron model (reference README walkthrough and JSS preprint
Table 3 benchmark; ``examples/timings.py:171-250``):

.. math::

    \dot V = c (V - V^3/3 + R), \qquad
    \dot R = -(V - a + b R) / c,

with :math:`\theta = (a, b, c) = (0.2, 0.2, 3)` and :math:`x_0 = (-1, 1)`.
"""
import jax
import jax.numpy as jnp

from rodeo_tpu.prior import ibm_init
from rodeo_tpu.utils import first_order_pad

__all__ = ["fitzhugh_fun", "fitzhugh_flat", "fitzhugh_jac_flat", "setup"]

N_VARS = 2
N_DERIV = 3
THETA = (0.2, 0.2, 3.0)
X0 = (-1.0, 1.0)


def fitzhugh_fun(X_t, t, theta):
    """FitzHugh-Nagumo in block form: ``X_t`` is ``(2, n_deriv)``."""
    a, b, c = theta[0], theta[1], theta[2]
    V, R = X_t[0, 0], X_t[1, 0]
    return jnp.array([
        [c * (V - V * V * V / 3 + R)],
        [-1.0 / c * (V - a + b * R)],
    ])


def fitzhugh_flat(x_cols, th, t):
    """FitzHugh-Nagumo right-hand side (see
    :func:`rodeo_tpu.models.lorenz.lorenz_flat` for the contract)."""
    del t
    x0 = x_cols[0]
    V, R = x0[0:1], x0[1:2]
    a, b, c = th[0:1], th[1:2], th[2:3]
    f0 = c * (V - V * V * V / 3.0 + R)
    f1 = -(V - a + b * R) / c
    return jnp.concatenate([f0, f1], axis=0)


def fitzhugh_jac_flat(x_cols, th, t):
    """Block-diagonal Jacobian columns of
    :func:`fitzhugh_flat`: ``d f_V / dV = c (1 - V^2)``,
    ``d f_R / dR = -b / c``."""
    del t
    x0 = x_cols[0]
    V = x0[0:1]
    b, c = th[1:2], th[2:3]
    dV = c * (1.0 - V * V)
    dR = -b / c
    col0 = jnp.concatenate([dV, dR], axis=0)
    return [col0] + [None] * (N_DERIV - 1)


def setup(n_steps=250, t_min=0.0, t_max=10.0, prior_sigma=0.1,
          dtype=jnp.float64):
    """Solver configuration for the FitzHugh-Nagumo benchmark."""
    theta = jnp.array(THETA, dtype=dtype)
    W, pad = first_order_pad(fitzhugh_fun, N_VARS, N_DERIV)
    x0 = pad(jnp.array(X0, dtype=dtype), t_min, theta=theta)
    dt = (t_max - t_min) / n_steps
    prior_pars = ibm_init(dt, N_DERIV, jnp.array([prior_sigma] * N_VARS,
                                                 dtype=dtype))
    return dict(
        ode_fun=fitzhugh_fun,
        ode_weight=W.astype(dtype),
        ode_init=x0.astype(dtype),
        theta=theta,
        t_min=t_min, t_max=t_max, n_steps=n_steps,
        prior_pars=jax.tree_util.tree_map(
            lambda a: a.astype(dtype), prior_pars),
    )
