"""
Bayesian parameter inference for the FitzHugh-Nagumo model: compare the
`basic` plug-in likelihood, the `fenrir` gradient-friendly likelihood, and
pseudo-marginal MCMC with vmapped chains (mirrors
docs/examples/parameter.md of the reference: all likelihoods are
jitted and chains are vmapped/shardable).

Run: python examples/parameter.py
"""
import numpy as np
import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import importlib
import rodeo_tpu
from rodeo_tpu.prior import ibm_init
from rodeo_tpu.utils import first_order_pad
from rodeo_tpu.interrogate import interrogate_rodeo, interrogate_kramer
from rodeo_tpu.models.fitzhugh import fitzhugh_fun
from rodeo_tpu.parallel import run_chains

fenrir_mod = importlib.import_module("rodeo_tpu.inference.fenrir")
basic_mod = importlib.import_module("rodeo_tpu.inference.basic")
pm = importlib.import_module("rodeo_tpu.inference.pseudo_marginal")


def main():
    n_vars, n_deriv = 2, 3
    t_min, t_max, n_steps = 0.0, 20.0, 400
    theta_true = jnp.array([0.2, 0.2, 3.0])
    W, pad = first_order_pad(fitzhugh_fun, n_vars, n_deriv)
    x0 = pad(jnp.array([-1.0, 1.0]), t_min, theta=theta_true)
    prior_pars = ibm_init((t_max - t_min) / n_steps, n_deriv,
                          jnp.array([0.01] * n_vars))
    key = jax.random.PRNGKey(0)

    # simulate noisy observations of both variables on a coarse grid
    mu, _ = rodeo_tpu.solve_mv(
        key=key, ode_fun=fitzhugh_fun, ode_weight=W, ode_init=x0,
        t_min=t_min, t_max=t_max, n_steps=n_steps,
        interrogate=interrogate_rodeo, prior_pars=prior_pars,
        theta=theta_true)
    n_obs = 21
    stride = n_steps // (n_obs - 1)
    obs_times = jnp.linspace(t_min, t_max, n_obs)
    gamma = 0.2
    obs = mu[::stride, :, :1] + gamma * jax.random.normal(
        jax.random.PRNGKey(1), (n_obs, n_vars, 1))
    D = jnp.zeros((n_obs, n_vars, 1, n_deriv)).at[:, :, :, 0].set(1.0)
    Om = gamma ** 2 * jnp.broadcast_to(jnp.eye(1), (n_obs, n_vars, 1, 1))

    # --- fenrir likelihood: jitted value+gradient ---
    def fenrir_ll(theta):
        return fenrir_mod.fenrir(
            key=None, ode_fun=fitzhugh_fun, ode_weight=W,
            ode_init=pad(jnp.array([-1.0, 1.0]), t_min, theta=theta),
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            interrogate=interrogate_kramer, prior_pars=prior_pars,
            obs_data=obs, obs_times=obs_times, obs_weight=D, obs_var=Om,
            theta=theta)

    vg = jax.jit(jax.value_and_grad(fenrir_ll))
    ll, g = vg(theta_true)
    print(f"fenrir loglik at true theta: {float(ll):.3f}, grad: {g}")

    # a few gradient-ascent steps move the loglik up
    theta = theta_true + jnp.array([0.05, -0.05, 0.2])
    ll0 = float(vg(theta)[0])
    for _ in range(20):
        ll_i, g = vg(theta)
        theta = theta + 1e-4 * g
    print(f"gradient ascent: {ll0:.3f} -> {float(vg(theta)[0]):.3f} "
          f"(theta={theta})")

    # --- pseudo-marginal MCMC, 8 vmapped chains ---
    def logpost(theta, key):
        ll, Xt = basic_mod.basic(
            key=key, ode_fun=fitzhugh_fun, ode_weight=W,
            ode_init=pad(jnp.array([-1.0, 1.0]), t_min, theta=theta),
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            interrogate=interrogate_rodeo, prior_pars=prior_pars,
            obs_data=obs, obs_times=obs_times,
            obs_loglik=lambda y, x, **p: jnp.sum(
                -0.5 * (y[..., 0] - x[..., 0]) ** 2 / gamma ** 2),
            theta=theta)
        return ll, Xt[-1]

    alg = pm.normal_random_walk(logpost, 0.02 * jnp.ones(3))
    init = jnp.broadcast_to(theta_true, (8, 3))
    positions, state, accept = run_chains(
        alg, init, jax.random.PRNGKey(2), n_samples=50)
    print(f"pseudo-marginal MCMC: 8 chains x 50 steps, "
          f"mean accept rate {float(jnp.mean(accept)):.2f}")
    print(f"posterior mean estimate: {jnp.mean(positions[25:], axis=(0, 1))}")


if __name__ == "__main__":
    main()
