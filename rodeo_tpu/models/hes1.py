r"""
Hes1 gene-regulation oscillator on the log scale (JSS preprint Table 3
benchmark; ``examples/timings.py:252-336``):

.. math::

    \dot P = -a H + b M / P - c, \quad
    \dot M = -d + e / (1 + P^2) / M, \quad
    \dot H = -a P + f/(H (1 + P^2)) - g,

solved for :math:`X = (\log P, \log M, \log H)`.
"""
import jax
import jax.numpy as jnp

from rodeo_tpu.prior import ibm_init
from rodeo_tpu.utils import first_order_pad

__all__ = ["hes1_fun", "hes1_flat", "setup"]

N_VARS = 3
N_DERIV = 3
THETA = (0.022, 0.3, 0.031, 0.028, 0.5, 20.0, 0.3)
X0 = (1.439, 2.037, 17.904)  # (P, M, H) levels


def hes1_fun(X_t, t, theta):
    """Hes1 in log-scale block form: ``X_t`` is ``(3, n_deriv)``."""
    a, b, c, d, e, f, g = (theta[i] for i in range(7))
    P, M, H = jnp.exp(X_t[:, 0])
    dP = -a * H + b * M / P - c
    dM = -d + e / (1 + P * P) / M
    dH = -a * P + f / (H * (1 + P * P)) - g
    return jnp.array([[dP], [dM], [dH]])


def hes1_flat(x_cols, th, t):
    """Hes1 right-hand side (log scale); see
    :func:`rodeo_tpu.models.lorenz.lorenz_flat` for the contract."""
    del t
    x0 = x_cols[0]
    P = jnp.exp(x0[0:1])
    M = jnp.exp(x0[1:2])
    H = jnp.exp(x0[2:3])
    a, b, c = th[0:1], th[1:2], th[2:3]
    d, e = th[3:4], th[4:5]
    f, g = th[5:6], th[6:7]
    one_p2 = 1.0 + P * P
    dP = -a * H + b * M / P - c
    dM = -d + e / one_p2 / M
    dH = -a * P + f / (H * one_p2) - g
    return jnp.concatenate([dP, dM, dH], axis=0)


def setup(n_steps=120, t_min=0.0, t_max=240.0, prior_sigma=0.1,
          dtype=jnp.float64):
    """Solver configuration for the Hes1 benchmark."""
    theta = jnp.array(THETA, dtype=dtype)
    W, pad = first_order_pad(hes1_fun, N_VARS, N_DERIV)
    x0 = pad(jnp.log(jnp.array(X0, dtype=dtype)), t_min, theta=theta)
    dt = (t_max - t_min) / n_steps
    prior_pars = ibm_init(dt, N_DERIV, jnp.array([prior_sigma] * N_VARS,
                                                 dtype=dtype))
    return dict(
        ode_fun=hes1_fun,
        ode_weight=W.astype(dtype),
        ode_init=x0.astype(dtype),
        theta=theta,
        t_min=t_min, t_max=t_max, n_steps=n_steps,
        prior_pars=jax.tree_util.tree_map(
            lambda a: a.astype(dtype), prior_pars),
    )
