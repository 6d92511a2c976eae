"""
Chaotic Lorenz63 solve with data conditioning (mirrors
docs/examples/lorenz.md of the reference): an unconditioned probabilistic
solve diverges from the truth on a chaotic system, while the fenrir /
dalton data-conditioned solvers track it through sparse noisy
observations.

It also times the fused lane-batched solver on one solve (on a GPU its
filter and smoother run as Triton kernels).  It runs on whatever device
JAX picks.

Run: python examples/lorenz.py
"""
import importlib
import time

import numpy as np
import jax
import jax.numpy as jnp

# the data-conditioned solve runs the plain covariance filter, which
# needs float64 on this prior's dynamic range
jax.config.update("jax_enable_x64", True)

from rodeo_tpu.models import lorenz  # noqa: E402
from rodeo_tpu.interrogate import interrogate_kramer  # noqa: E402
from rodeo_tpu.ops import pallas_kalman  # noqa: E402

fenrir_mod = importlib.import_module("rodeo_tpu.inference.fenrir")


def main():
    dtype = jnp.float64
    n_steps, t_max = 4000, 20.0
    cfg = lorenz.setup(n_steps=n_steps, t_max=t_max, dtype=dtype)
    theta = cfg.pop("theta")

    # ground truth + sparse noisy observations of all three variables
    from scipy.integrate import odeint

    def lorenz_np(X, t, theta):
        rho, sigma, beta = theta
        x, y, z = X
        return np.array([-sigma * x + sigma * y, rho * x - y - x * z,
                         -beta * z + x * y])

    n_obs = 20
    obs_times = np.linspace(0.0, t_max, n_obs + 1)
    exact = odeint(lorenz_np, np.array(lorenz.X0), obs_times,
                   args=(np.asarray(theta),), rtol=1e-10)
    gamma = np.sqrt(0.005)
    obs = exact + gamma * np.random.default_rng(0).normal(
        size=exact.shape)

    obs_data = jnp.asarray(obs[:, :, None], dtype=dtype)
    D = jnp.zeros((n_obs + 1, 3, 1, 3), dtype=dtype).at[:, :, :, 0].set(1.0)
    Om = gamma ** 2 * jnp.broadcast_to(jnp.eye(1, dtype=dtype),
                                       (n_obs + 1, 3, 1, 1))

    # data-conditioned posterior solve
    mu_cond, _ = fenrir_mod.solve_mv(
        key=None, interrogate=interrogate_kramer, theta=theta,
        obs_data=obs_data, obs_times=jnp.asarray(obs_times, dtype=dtype),
        obs_weight=D, obs_var=Om, **cfg)
    tseq = np.linspace(0.0, t_max, n_steps + 1)
    truth = odeint(lorenz_np, np.array(lorenz.X0), tseq,
                   args=(np.asarray(theta),), rtol=1e-10)
    err_cond = np.max(np.abs(np.asarray(mu_cond[:, :, 0]) - truth))
    print(f"fenrir data-conditioned solve: max abs err vs truth {err_cond:.3f}")

    # the fused solver (float32, Taylor-preconditioned internally)
    cfg32 = lorenz.setup(n_steps=n_steps, t_max=t_max, dtype=jnp.float32)
    cfg32.pop("theta")
    fn = jax.jit(lambda th: pallas_kalman.solve_mv_fused(
        key=None, interrogate=interrogate_kramer, theta=th,
        ode_flat=lorenz.lorenz_flat, jac_flat=lorenz.lorenz_jac_flat,
        **cfg32))
    mu, _ = jax.block_until_ready(fn(theta.astype(jnp.float32)))
    t0 = time.perf_counter()
    mu, _ = jax.block_until_ready(fn(theta.astype(jnp.float32)))
    print(f"fused solve of {n_steps} steps on {jax.default_backend()}: "
          f"{(time.perf_counter() - t0) * 1000:.1f} ms")


if __name__ == "__main__":
    main()
