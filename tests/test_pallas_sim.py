"""
Fused lane-batched posterior sampling + fused MCMC tests (the scan
driver on CPU).

The sampler is stochastic, so correctness is checked distributionally: the
lane-marginal law of solve_sim draws equals the smoothing posterior
N(mean_smooth, var_smooth) per time/state coordinate.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rodeo_tpu.ops import pallas_kalman, pallas_sim
from rodeo_tpu.models import fitzhugh, lorenz


@pytest.fixture(scope="module")
def lorenz_cfg():
    # n_steps=200 makes the backward length 199 (prime), exercising the
    # front-padded chunking path
    cfg = lorenz.setup(n_steps=200, t_max=2.0, dtype=jnp.float32)
    theta = cfg.pop("theta")
    return cfg, theta


def test_sim_batch_marginals_match_smoother(lorenz_cfg):
    cfg, theta = lorenz_cfg
    B = 64
    thetas = jnp.broadcast_to(theta, (B, 3))
    inits = jnp.broadcast_to(cfg["ode_init"], (B,) + cfg["ode_init"].shape)
    kw = dict(thetas=thetas, ode_weight=cfg["ode_weight"], ode_inits=inits,
              t_min=cfg["t_min"], t_max=cfg["t_max"],
              n_steps=cfg["n_steps"], prior_pars=cfg["prior_pars"],
              ode_flat=lorenz.lorenz_flat, jac_flat=lorenz.lorenz_jac_flat)
    paths = pallas_sim.solve_sim_fused_batch(key=jax.random.PRNGKey(0), **kw)
    assert paths.shape == (cfg["n_steps"] + 1, 3, 3, B)
    assert bool(jnp.all(jnp.isfinite(paths)))
    # identical initial state on every lane, exactly
    np.testing.assert_allclose(
        np.asarray(paths[0]), np.asarray(inits[0])[..., None]
        * np.ones(B), rtol=1e-6)

    mu, var_packed = pallas_kalman.solve_mv_fused_batch(**kw)
    var = pallas_kalman.unpack_cov(
        jnp.moveaxis(var_packed, -1, 0))          # (B, N+1, nb, q, q)
    sd = jnp.sqrt(jnp.maximum(
        jnp.moveaxis(jnp.diagonal(var, axis1=-2, axis2=-1), 0, -1), 0.0))
    z = (paths - mu) / jnp.maximum(sd, 1e-6)
    z = np.asarray(z[1:])                          # exclude exact x0
    # lanes are independent N(0,1) per coordinate: bounded + unit spread
    assert np.abs(z).max() < 8.0
    spread = z.std(axis=-1)                        # over lanes
    mask = np.asarray(sd[1:, ..., 0]) > 1e-5       # non-degenerate coords
    if mask.any():
        avg_spread = spread[mask].mean()
        assert 0.7 < avg_spread < 1.3, avg_spread


def test_sim_batch_distinct_lanes_distinct_draws(lorenz_cfg):
    cfg, theta = lorenz_cfg
    B = 4
    thetas = jnp.broadcast_to(theta, (B, 3))
    inits = jnp.broadcast_to(cfg["ode_init"], (B,) + cfg["ode_init"].shape)
    paths = pallas_sim.solve_sim_fused_batch(
        key=jax.random.PRNGKey(1), thetas=thetas,
        ode_weight=cfg["ode_weight"], ode_inits=inits,
        t_min=cfg["t_min"], t_max=cfg["t_max"], n_steps=cfg["n_steps"],
        prior_pars=cfg["prior_pars"], ode_flat=lorenz.lorenz_flat,
        jac_flat=lorenz.lorenz_jac_flat)
    # every lane pair differs somewhere after t=0
    for i in range(B):
        for j in range(i + 1, B):
            assert float(jnp.max(jnp.abs(
                paths[1:, ..., i] - paths[1:, ..., j]))) > 0.0


def test_sim_batch_consistent_with_xla_posterior(lorenz_cfg):
    """Cross-implementation check: fused draws are z-score-plausible under
    the *XLA* preconditioned solver's smoothing posterior (catches any
    coordinate/scaling mismatch between the two implementations)."""
    from rodeo_tpu.ops import precond
    from rodeo_tpu.interrogate import interrogate_kramer
    cfg, theta = lorenz_cfg
    mu, var = precond.solve_mv(
        key=None, interrogate=interrogate_kramer, theta=theta, **cfg)
    sd = jnp.sqrt(jnp.maximum(
        jnp.diagonal(var, axis1=-2, axis2=-1), 0.0))
    B = 16
    paths = pallas_sim.solve_sim_fused_batch(
        key=jax.random.PRNGKey(3), thetas=jnp.broadcast_to(theta, (B, 3)),
        ode_weight=cfg["ode_weight"],
        ode_inits=jnp.broadcast_to(cfg["ode_init"],
                                   (B,) + cfg["ode_init"].shape),
        t_min=cfg["t_min"], t_max=cfg["t_max"], n_steps=cfg["n_steps"],
        prior_pars=cfg["prior_pars"], ode_flat=lorenz.lorenz_flat,
        jac_flat=lorenz.lorenz_jac_flat)
    z = (paths - mu[..., None]) / jnp.maximum(sd[..., None], 1e-5)
    assert float(jnp.max(jnp.abs(z[1:]))) < 8.0


def test_chain_runner_chkrebtii_interrogation():
    """The lockstep MCMC runner supports the chkrebtii (stochastic)
    interrogation — the reference's canonical pseudo-marginal workflow."""
    from rodeo_tpu.parallel.chains import make_chain_runner
    cfg = fitzhugh.setup(n_steps=20, t_max=2.0, dtype=jnp.float32)
    theta = cfg.pop("theta")
    mu_ref, _ = pallas_kalman.solve_mv_fused(
        key=None, interrogate=None, theta=theta,
        ode_flat=fitzhugh.fitzhugh_flat,
        jac_flat=fitzhugh.fitzhugh_jac_flat, **cfg)

    def loglik(positions, paths):
        resid = paths[:, :, 0, :] - mu_ref[:, :, 0, None]
        return -0.5 * jnp.sum(resid * resid, axis=(0, 1)) / 0.01

    B = 8
    runner = make_chain_runner(
        loglik, n_lane=B, n_samples=5, rw_scale=0.05,
        ode_weight=cfg["ode_weight"], ode_init=cfg["ode_init"],
        t_min=cfg["t_min"], t_max=cfg["t_max"], n_steps=cfg["n_steps"],
        prior_pars=cfg["prior_pars"], ode_flat=fitzhugh.fitzhugh_flat,
        jac_flat=None, interrogation="chkrebtii")
    init = jnp.broadcast_to(theta, (B, 3)).astype(jnp.float32)
    positions, ll, accept = runner(init, jax.random.PRNGKey(11))
    assert positions.shape == (5, B, 3)
    assert bool(jnp.all(jnp.isfinite(ll)))


def test_fused_chains_acceptance_matches_xla():
    """Pseudo-marginal acceptance statistics are unchanged between the
    fused lockstep chains and the vmapped XLA pseudo-marginal sampler
    (same model, proposal scale, matched horizon; deterministic keys)."""
    from rodeo_tpu.ops import precond
    from rodeo_tpu.parallel import run_chains, run_chains_fused
    from rodeo_tpu.inference import pseudo_marginal as pm
    from rodeo_tpu.interrogate import interrogate_kramer
    cfg = fitzhugh.setup(n_steps=20, t_max=2.0, dtype=jnp.float32)
    th = cfg.pop("theta")
    mu_ref, _ = precond.solve_mv(
        key=None, interrogate=interrogate_kramer, theta=th, **cfg)
    n_chains, n_samp = 8, 20
    init = jnp.broadcast_to(th, (n_chains, 3)).astype(jnp.float32)

    def logpost(theta, key):
        xs = precond.solve_sim(key=key, interrogate=interrogate_kramer,
                               theta=theta, method="eigh", **cfg)
        return -0.5 * jnp.sum((xs[:, :, 0] - mu_ref[:, :, 0])**2) / 0.01, \
            xs[-1]

    alg = pm.normal_random_walk(logpost, 0.05 * jnp.ones(3, jnp.float32))
    _, _, acc_x = run_chains(alg, init, jax.random.PRNGKey(3),
                             n_samples=n_samp)

    def loglik(positions, paths):
        r = paths[:, :, 0, :] - mu_ref[:, :, 0, None]
        return -0.5 * jnp.sum(r * r, axis=(0, 1)) / 0.01

    _, _, acc_f = run_chains_fused(
        loglik, init, jax.random.PRNGKey(3), n_samples=n_samp,
        rw_scale=0.05, ode_weight=cfg["ode_weight"],
        ode_init=cfg["ode_init"], t_min=cfg["t_min"], t_max=cfg["t_max"],
        n_steps=cfg["n_steps"], prior_pars=cfg["prior_pars"],
        ode_flat=fitzhugh.fitzhugh_flat,
        jac_flat=fitzhugh.fitzhugh_jac_flat)
    a_x, a_f = float(jnp.mean(acc_x)), float(jnp.mean(acc_f))
    assert abs(a_x - a_f) < 0.25, (a_x, a_f)


def test_run_chains_fused():
    from rodeo_tpu.parallel import run_chains_fused
    cfg = fitzhugh.setup(n_steps=20, t_max=2.0, dtype=jnp.float32)
    theta = cfg.pop("theta")
    mu_ref, _ = pallas_kalman.solve_mv_fused(
        key=None, interrogate=None, theta=theta,
        ode_flat=fitzhugh.fitzhugh_flat,
        jac_flat=fitzhugh.fitzhugh_jac_flat, **cfg)

    def loglik(positions, paths):
        resid = paths[:, :, 0, :] - mu_ref[:, :, 0, None]
        return -0.5 * jnp.sum(resid * resid, axis=(0, 1)) / 0.01

    B, n_samp = 8, 6
    init = jnp.broadcast_to(theta, (B, 3)).astype(jnp.float32)
    positions, ll, accept = run_chains_fused(
        loglik, init, jax.random.PRNGKey(4), n_samples=n_samp,
        rw_scale=0.02, ode_weight=cfg["ode_weight"],
        ode_init=cfg["ode_init"], t_min=cfg["t_min"], t_max=cfg["t_max"],
        n_steps=cfg["n_steps"], prior_pars=cfg["prior_pars"],
        ode_flat=fitzhugh.fitzhugh_flat,
        jac_flat=fitzhugh.fitzhugh_jac_flat)
    assert positions.shape == (n_samp, B, 3)
    assert ll.shape == (B,) and bool(jnp.all(jnp.isfinite(ll)))
    assert accept.shape == (B,)
    assert float(jnp.mean(accept)) > 0.0          # some moves accepted
    assert bool(jnp.all(jnp.isfinite(positions)))
