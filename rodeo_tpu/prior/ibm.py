r"""
q-times integrated Brownian motion (IBM) solution prior.

For the prior :math:`x^{(q)}(t) = \sigma B(t)`, the discrete-time transition
and process-noise matrices have the closed forms

.. math::

    Q_{ij} = \mathbb{1}_{i \le j} \frac{(\Delta t)^{j-i}}{(j-i)!}, \qquad
    R_{ij} = \sigma^2
      \frac{(\Delta t)^{2q-1-i-j}}{(2q-1-i-j)\,(q-i)!\,(q-j)!}.

Functional parity target: ``/root/reference/src/rodeo/prior/ibm.py``
(``ibm_state``, ``ibm_init``).  Everything here is closed-form and device
resident, so the prior construction traces into the same XLA program as the
solve.
"""
import math

import jax
import jax.numpy as jnp

__all__ = ["ibm_state", "ibm_init"]


def ibm_state(dt, q, sigma):
    r"""
    Transition matrix ``Q`` and process-noise matrix ``R`` of the q-times
    integrated Brownian motion over a step of size ``dt``.

    Parity: ``prior/ibm.py:37-62``.

    ACCURACY NOTE: the combinatorial coefficients are exact Python
    floats folded in at trace time, and the ``dt`` powers are built by
    iterated multiplication — never ``pow``/``gammaln`` device
    transcendentals, whose few-ulp float32 approximations on a device can
    perturb the prior by ~1e-4 relative and (on chaotic systems) blow the
    solve
    accuracy from ~1e-3 to ~0.5 absolute (measured, Lorenz63 t<=4).
    Remains fully jittable in ``dt``.

    Args:
        dt (float): Step size (may be traced).
        q (int): Number of integrations (static; state dim is ``q + 1``).
        sigma (float): Diffusion scale.

    Returns:
        (tuple): ``Q`` (q+1, q+1) and ``R`` (q+1, q+1).
    """
    dt = jnp.asarray(dt)
    # dt^k for k = 0..2q+1 by iterated multiplication (1 rounding per
    # power instead of exp(k log dt) transcendental error)
    pows = [jnp.ones_like(dt)]
    for _ in range(2 * q + 1):
        pows.append(pows[-1] * dt)
    Q = jnp.stack([
        jnp.stack([pows[j - i] / math.factorial(j - i)
                   if j >= i else jnp.zeros_like(dt)
                   for j in range(q + 1)])
        for i in range(q + 1)])
    R = jnp.stack([
        jnp.stack([pows[2 * q + 1 - i - j]
                   / ((2 * q + 1 - i - j)
                      * math.factorial(q - i) * math.factorial(q - j))
                   for j in range(q + 1)])
        for i in range(q + 1)])
    return Q, sigma ** 2 * R


def ibm_init(dt, n_deriv, sigma):
    r"""
    Stacked block IBM prior parameters for the Kalman solver.

    Builds one ``(q+1, q+1)`` pair with unit diffusion and broadcasts it to
    ``n_block = len(sigma)`` blocks, scaling the noise of block ``b`` by
    ``sigma[b]**2``.  Parity: ``prior/ibm.py:65-88``.

    Args:
        dt (float): Step size.
        n_deriv (int): State dimension per block (``q + 1``).
        sigma (ndarray(n_block)): Per-block diffusion scales.

    Returns:
        (tuple):
        - **prior_weight** (ndarray(n_block, n_deriv, n_deriv)): :math:`Q`.
        - **prior_var** (ndarray(n_block, n_deriv, n_deriv)): :math:`R`.
    """
    sigma = jnp.asarray(sigma)
    n_block = sigma.shape[0]
    wgt_one, var_one = ibm_state(dt, n_deriv - 1, 1.0)
    prior_weight = jnp.broadcast_to(
        wgt_one, (n_block,) + wgt_one.shape)
    prior_var = sigma[:, None, None] ** 2 * var_one
    return prior_weight, prior_var
