r"""
Lorenz63 chaotic system — the flagship benchmark model
(cf. reference ``docs/examples/lorenz.md``):

.. math::

    \dot x = \sigma(y - x), \quad
    \dot y = x(\rho - z) - y, \quad
    \dot z = x y - \beta z,

with :math:`(\rho, \sigma, \beta) = (28, 10, 8/3)` and
:math:`x_0 = (-12, -5, 38)`.
"""
import jax
import jax.numpy as jnp

from rodeo_tpu.prior import ibm_init
from rodeo_tpu.utils import first_order_pad

__all__ = ["lorenz_fun", "lorenz_flat", "lorenz_jac_flat", "setup"]

N_VARS = 3
N_DERIV = 3
THETA = (28.0, 10.0, 8.0 / 3.0)
X0 = (-12.0, -5.0, 38.0)


def lorenz_fun(X_t, t, theta):
    """Lorenz63 in block form: ``X_t`` is ``(3, n_deriv)``."""
    rho, sigma, beta = theta[0], theta[1], theta[2]
    x, y, z = X_t[:, 0]
    dx = -sigma * x + sigma * y
    dy = rho * x - y - x * z
    dz = -beta * z + x * y
    return jnp.array([[dx], [dy], [dz]])


def lorenz_flat(x_cols, th, t):
    """Lorenz63 right-hand side for the fused solvers (the ``*_flat``
    contract of :mod:`rodeo_tpu.ops.pallas_kalman`).

    ``x_cols`` is a list of ``n_deriv`` columns of shape
    ``(n_vars, n_lane)`` (column ``j`` = j-th derivative of every
    variable, one row per variable); ``th`` is ``(n_theta, n_lane)``, one
    row per parameter.  Returns ``(n_vars, n_lane)``.  Only row slices,
    elementwise math and row concatenation are used (the operations
    :mod:`rodeo_tpu.ops.flat_rows` allows), so the same callable runs
    under the scan driver and inside the GPU kernels.
    """
    del t
    x0 = x_cols[0]
    x, y, z = x0[0:1], x0[1:2], x0[2:3]
    rho, sigma, beta = th[0:1], th[1:2], th[2:3]
    f0 = -sigma * x + sigma * y
    f1 = rho * x - y - x * z
    f2 = -beta * z + x * y
    return jnp.concatenate([f0, f1, f2], axis=0)


def lorenz_jac_flat(x_cols, th, t):
    """Block-diagonal Jacobian columns of :func:`lorenz_flat`.

    Column ``j`` is ``d f_b / d x_{b,j}`` of shape ``(3, n_lane)``
    (same row layout as :func:`lorenz_flat`); ``None`` marks known-zero
    columns.  Only the 0th derivative enters ``f``, and the in-block
    partials are ``(-sigma, -1, -beta)``.
    """
    del x_cols, t
    sigma, beta = th[1:2], th[2:3]
    one = jnp.ones_like(sigma)
    col0 = jnp.concatenate([-sigma, -one, -beta], axis=0)
    return [col0] + [None] * (N_DERIV - 1)


def setup(n_steps=10000, t_min=0.0, t_max=20.0, prior_sigma=5e7,
          dtype=jnp.float32):
    """
    Full solver configuration for the Lorenz63 benchmark
    (``lorenz.md:94-121``; grid size per BASELINE.json: 10k steps).

    Returns:
        dict with ``ode_fun, W, x0, theta, t_min, t_max, n_steps,
        prior_pars`` ready to splat into ``solve_mv``.
    """
    theta = jnp.array(THETA, dtype=dtype)
    W, pad = first_order_pad(lorenz_fun, N_VARS, N_DERIV)
    x0 = pad(jnp.array(X0, dtype=dtype), t_min, theta=theta)
    dt = (t_max - t_min) / n_steps
    prior_pars = ibm_init(dt, N_DERIV, jnp.array([prior_sigma] * N_VARS,
                                                 dtype=dtype))
    return dict(
        ode_fun=lorenz_fun,
        ode_weight=W.astype(dtype),
        ode_init=x0.astype(dtype),
        theta=theta,
        t_min=t_min, t_max=t_max, n_steps=n_steps,
        prior_pars=jax.tree_util.tree_map(
            lambda a: a.astype(dtype), prior_pars),
    )
