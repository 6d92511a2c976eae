r"""
SEIRAH six-compartment COVID-19 model (JSS preprint Table 3 benchmark;
``examples/timings.py:338-454``):

.. math::

    \dot S = -b S (I + \alpha A)/N, \quad
    \dot E = b S (I + \alpha A)/N - E/D_e, \ldots

State :math:`(S, E, I, R, A, H)`, parameters
:math:`\theta = (b, r, \alpha, D_e, D_I, D_q)`.
"""
import jax
import jax.numpy as jnp

from rodeo_tpu.prior import ibm_init
from rodeo_tpu.utils import first_order_pad

__all__ = ["seirah_fun", "seirah_flat", "setup"]

N_VARS = 6
N_DERIV = 3
THETA = (2.23, 0.034, 0.55, 5.1, 2.3, 1.13)
X0 = (63884630.0, 15492.0, 21752.0, 0.0, 618013.0, 93583.0)
D_H = 30.0  # fixed hospitalization duration


def seirah_fun(X_t, t, theta):
    """SEIRAH in block form: ``X_t`` is ``(6, n_deriv)``."""
    b, r, alpha, D_e, D_I, D_q = (theta[i] for i in range(6))
    S, E, I, R, A, H = X_t[:, 0]
    N = S + E + I + R + A + H
    D_h = D_H
    dS = -b * S * (I + alpha * A) / N
    dE = b * S * (I + alpha * A) / N - E / D_e
    dI = r * E / D_e - I / D_q - I / D_I
    dR = (I + A) / D_I + H / D_h
    dA = (1 - r) * E / D_e - A / D_I
    dH = I / D_q - H / D_h
    return jnp.array([[dS], [dE], [dI], [dR], [dA], [dH]])


def seirah_flat(x_cols, th, t):
    """SEIRAH right-hand side; see
    :func:`rodeo_tpu.models.lorenz.lorenz_flat` for the contract."""
    del t
    x0 = x_cols[0]
    S, E, I = x0[0:1], x0[1:2], x0[2:3]
    R, A, H = x0[3:4], x0[4:5], x0[5:6]
    b, r, alpha = th[0:1], th[1:2], th[2:3]
    D_e, D_I, D_q = th[3:4], th[4:5], th[5:6]
    N = S + E + I + R + A + H
    inf = b * S * (I + alpha * A) / N
    dS = -inf
    dE = inf - E / D_e
    dI = r * E / D_e - I / D_q - I / D_I
    dR = (I + A) / D_I + H / D_H
    dA = (1.0 - r) * E / D_e - A / D_I
    dH = I / D_q - H / D_H
    return jnp.concatenate([dS, dE, dI, dR, dA, dH], axis=0)


def setup(n_steps=80, t_min=0.0, t_max=60.0, prior_sigma=0.1,
          dtype=jnp.float64):
    """Solver configuration for the SEIRAH benchmark."""
    theta = jnp.array(THETA, dtype=dtype)
    W, pad = first_order_pad(seirah_fun, N_VARS, N_DERIV)
    x0 = pad(jnp.array(X0, dtype=dtype), t_min, theta=theta)
    dt = (t_max - t_min) / n_steps
    prior_pars = ibm_init(dt, N_DERIV, jnp.array([prior_sigma] * N_VARS,
                                                 dtype=dtype))
    return dict(
        ode_fun=seirah_fun,
        ode_weight=W.astype(dtype),
        ode_init=x0.astype(dtype),
        theta=theta,
        t_min=t_min, t_max=t_max, n_steps=n_steps,
        prior_pars=jax.tree_util.tree_map(
            lambda a: a.astype(dtype), prior_pars),
    )
