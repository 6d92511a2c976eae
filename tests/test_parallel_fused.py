"""
Multi-chip sharding of the fused lane-batched solvers (8 virtual CPU
devices via conftest; the fused step functions run on the scan driver).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rodeo_tpu.models import lorenz, fitzhugh
from rodeo_tpu.ops import pallas_kalman, pallas_fenrir
from rodeo_tpu.parallel import (
    make_mesh, sharded_solve_mv_fused_batch, sharded_fenrir_fused_batch,
    sharded_solve_sim_fused_batch, run_chains_fused_sharded)


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8
    return make_mesh(n_devices=8, axis_name="batch")


@pytest.fixture(scope="module")
def lorenz_cfg():
    cfg = lorenz.setup(n_steps=100, t_max=1.0, dtype=jnp.float32)
    cfg.pop("theta")
    return cfg


def test_sharded_solve_mv_fused_batch(mesh):
    # FitzHugh (non-chaotic): the sharded and unsharded paths differ only
    # by f32 reduction order (per-shard lane counts change the XLA gain
    # precompute vectorization), which chaotic systems would amplify
    cfg = fitzhugh.setup(n_steps=100, t_max=4.0, dtype=jnp.float32)
    theta = cfg.pop("theta")
    B = 16                                  # 2 lanes per device
    thetas = jnp.stack([theta * (1 + 0.01 * i) for i in range(B)])
    inits = jnp.broadcast_to(cfg["ode_init"], (B,) + cfg["ode_init"].shape)
    kw = dict(ode_weight=cfg["ode_weight"], t_min=cfg["t_min"],
              t_max=cfg["t_max"], n_steps=cfg["n_steps"],
              prior_pars=cfg["prior_pars"], ode_flat=fitzhugh.fitzhugh_flat,
              jac_flat=fitzhugh.fitzhugh_jac_flat)
    mu_s, var_s = sharded_solve_mv_fused_batch(
        thetas=thetas, ode_inits=inits, mesh=mesh, **kw)
    mu_1, var_1 = pallas_kalman.solve_mv_fused_batch(
        thetas=thetas, ode_inits=inits, **kw)
    np.testing.assert_allclose(np.asarray(mu_s), np.asarray(mu_1),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(var_s), np.asarray(var_1),
                               rtol=1e-2, atol=1e-2 * float(
                                   jnp.max(jnp.abs(var_1))))


def test_sharded_fenrir_fused_batch(mesh, lorenz_cfg):
    cfg = lorenz_cfg
    rng = np.random.default_rng(31)
    n_obs = 3
    obs_times = jnp.linspace(0.0, 1.0, n_obs).astype(jnp.float32)
    D = jnp.zeros((n_obs, 3, 1, 3), jnp.float32).at[:, :, :, 0].set(1.0)
    Om = 0.01 * jnp.broadcast_to(jnp.eye(1, dtype=jnp.float32),
                                 (n_obs, 3, 1, 1))
    yobs = jnp.asarray(rng.normal(size=(n_obs, 3, 1)) * 3, jnp.float32)
    B = 8
    theta = jnp.array([28.0, 10.0, 8.0 / 3.0], jnp.float32)
    thetas = jnp.stack([theta * (1 + 0.01 * i) for i in range(B)])
    inits = jnp.broadcast_to(cfg["ode_init"], (B,) + cfg["ode_init"].shape)
    kw = dict(ode_weight=cfg["ode_weight"], t_min=cfg["t_min"],
              t_max=cfg["t_max"], n_steps=cfg["n_steps"],
              prior_pars=cfg["prior_pars"],
              obs_data=yobs, obs_times=obs_times, obs_weight=D, obs_var=Om,
              ode_flat=lorenz.lorenz_flat, jac_flat=lorenz.lorenz_jac_flat)
    ll_s = sharded_fenrir_fused_batch(
        thetas=thetas, ode_inits=inits, mesh=mesh, **kw)
    ll_1 = pallas_fenrir.fenrir_fused_batch(
        thetas=thetas, ode_inits=inits, **kw)
    np.testing.assert_allclose(np.asarray(ll_s), np.asarray(ll_1),
                               rtol=1e-4)


def test_sharded_solve_sim_fused_batch(mesh, lorenz_cfg):
    cfg = lorenz_cfg
    B = 16
    theta = jnp.array([28.0, 10.0, 8.0 / 3.0], jnp.float32)
    thetas = jnp.broadcast_to(theta, (B, 3))
    inits = jnp.broadcast_to(cfg["ode_init"], (B,) + cfg["ode_init"].shape)
    paths = sharded_solve_sim_fused_batch(
        key=jax.random.PRNGKey(0), thetas=thetas, ode_inits=inits,
        mesh=mesh, ode_weight=cfg["ode_weight"], t_min=cfg["t_min"],
        t_max=cfg["t_max"], n_steps=cfg["n_steps"],
        prior_pars=cfg["prior_pars"], ode_flat=lorenz.lorenz_flat,
        jac_flat=lorenz.lorenz_jac_flat)
    assert paths.shape == (cfg["n_steps"] + 1, 3, 3, B)
    assert bool(jnp.all(jnp.isfinite(paths)))
    # lanes on different devices draw different noise
    assert float(jnp.max(jnp.abs(paths[1:, ..., 0] - paths[1:, ..., B - 1]
                                 ))) > 0.0


def test_run_chains_fused_sharded(mesh):
    cfg = fitzhugh.setup(n_steps=20, t_max=2.0, dtype=jnp.float32)
    theta = cfg.pop("theta")
    mu_ref, _ = pallas_kalman.solve_mv_fused(
        key=None, interrogate=None, theta=theta,
        ode_flat=fitzhugh.fitzhugh_flat,
        jac_flat=fitzhugh.fitzhugh_jac_flat, **cfg)

    def loglik(positions, paths):
        resid = paths[:, :, 0, :] - mu_ref[:, :, 0, None]
        return -0.5 * jnp.sum(resid * resid, axis=(0, 1)) / 0.01

    B, n_samp = 16, 4
    init = jnp.broadcast_to(theta, (B, 3)).astype(jnp.float32)
    positions, ll, accept = run_chains_fused_sharded(
        loglik, init, jax.random.PRNGKey(7), n_samples=n_samp,
        rw_scale=0.02, ode_weight=cfg["ode_weight"],
        ode_init=cfg["ode_init"], t_min=cfg["t_min"], t_max=cfg["t_max"],
        n_steps=cfg["n_steps"], prior_pars=cfg["prior_pars"],
        ode_flat=fitzhugh.fitzhugh_flat,
        jac_flat=fitzhugh.fitzhugh_jac_flat, mesh=mesh, axis_name="batch")
    assert positions.shape == (n_samp, B, 3)
    assert ll.shape == (B,) and bool(jnp.all(jnp.isfinite(ll)))
    assert float(jnp.mean(accept)) > 0.0


def test_chain_runner_runtime_scale():
    """The proposal scale is a runtime (traced) argument: re-tuning must
    not re-trace, and different scales must change acceptance."""
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

    B, n_samp = 16, 8
    init = jnp.broadcast_to(theta, (B, 3)).astype(jnp.float32)
    runner = make_chain_runner(
        loglik, n_lane=B, n_samples=n_samp, rw_scale=0.02,
        ode_weight=cfg["ode_weight"], ode_init=cfg["ode_init"],
        t_min=cfg["t_min"], t_max=cfg["t_max"], n_steps=cfg["n_steps"],
        prior_pars=cfg["prior_pars"], ode_flat=fitzhugh.fitzhugh_flat,
        jac_flat=fitzhugh.fitzhugh_jac_flat)
    p1, _, acc_small = runner(init, jax.random.PRNGKey(1), scale=1e-4)
    p2, _, acc_big = runner(init, jax.random.PRNGKey(1), scale=5.0)
    assert p1.shape == (n_samp, B, 3)
    # a tiny proposal accepts (almost) always; a huge one (almost) never
    assert float(jnp.mean(acc_small)) > float(jnp.mean(acc_big))
    # default falls back to the build-time scale
    p3, _, _ = runner(init, jax.random.PRNGKey(1))
    assert p3.shape == (n_samp, B, 3)


def test_sharded_dalton_daltonng_basic(mesh):
    """Sharded dalton/daltonng/basic fused wrappers == single-mesh calls
    (8 virtual devices)."""
    from rodeo_tpu.parallel import (
        sharded_dalton_fused_batch, sharded_daltonng_fused_batch,
        sharded_basic_fused_batch)
    from rodeo_tpu.ops import pallas_dalton, pallas_daltonng
    from rodeo_tpu.models import lorenz as lz
    cfg = lz.setup(n_steps=40, t_max=0.4, dtype=jnp.float32)
    theta = cfg.pop("theta")
    B = 16
    thetas = jnp.broadcast_to(theta, (B, 3)) * \
        (1 + 1e-5 * jnp.arange(B, dtype=jnp.float32)[:, None])
    inits = jnp.broadcast_to(cfg["ode_init"], (B,) + cfg["ode_init"].shape)
    n_obs = 3
    obs_times = jnp.linspace(0.0, 0.4, n_obs).astype(jnp.float32)
    rng = np.random.default_rng(4)
    yobs = jnp.asarray(rng.normal(size=(n_obs, 3, 1)) * 3, jnp.float32)
    D = jnp.zeros((n_obs, 3, 1, 3), jnp.float32).at[:, :, :, 0].set(1.0)
    Om = 0.01 * jnp.broadcast_to(jnp.eye(1, dtype=jnp.float32),
                                 (n_obs, 3, 1, 1))
    base = dict(ode_weight=cfg["ode_weight"], ode_inits=inits,
                t_min=cfg["t_min"], t_max=cfg["t_max"],
                n_steps=cfg["n_steps"], prior_pars=cfg["prior_pars"],
                ode_flat=lz.lorenz_flat, jac_flat=lz.lorenz_jac_flat)

    ll_s = sharded_dalton_fused_batch(
        thetas=thetas, obs_data=yobs, obs_times=obs_times,
        obs_weight=D, obs_var=Om, mesh=mesh, **base)
    ll_1 = pallas_dalton.dalton_fused_batch(
        thetas=thetas, obs_data=yobs, obs_times=obs_times,
        obs_weight=D, obs_var=Om, **base)
    np.testing.assert_allclose(np.asarray(ll_s), np.asarray(ll_1),
                               rtol=1e-5)

    def comp(y_cols, x_col, j, th, iobs):
        return -0.5 * (y_cols[0] - x_col) ** 2 / 0.01

    llng_s = sharded_daltonng_fused_batch(
        thetas=thetas, obs_data=yobs, obs_times=obs_times,
        obs_comp_flat=comp, obs_dims=(0,), mesh=mesh, **base)
    llng_1 = pallas_daltonng.daltonng_fused_batch(
        thetas=thetas, obs_data=yobs, obs_times=obs_times,
        obs_comp_flat=comp, obs_dims=(0,), **base)
    np.testing.assert_allclose(np.asarray(llng_s), np.asarray(llng_1),
                               rtol=1e-5)

    def b_loglik(obs_data, ode_data, **p):
        return jnp.sum(-0.5 * (obs_data[..., 0] - ode_data[..., 0]) ** 2)

    llb_s, mu_s = sharded_basic_fused_batch(
        thetas=thetas, obs_data=yobs, obs_times=obs_times,
        obs_loglik=b_loglik, mesh=mesh, **base)
    llb_1, mu_1 = pallas_kalman.basic_fused_batch(
        thetas=thetas, obs_data=yobs, obs_times=obs_times,
        obs_loglik=b_loglik, **base)
    np.testing.assert_allclose(np.asarray(llb_s), np.asarray(llb_1),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(mu_s), np.asarray(mu_1),
                               rtol=1e-5, atol=1e-5)


def test_sharded_grad_wrappers(mesh):
    """Sharded fenrir/dalton/basic GRADIENT wrappers == single-mesh calls
    (8 virtual devices)."""
    from rodeo_tpu.parallel import (
        sharded_fenrir_fused_batch_grad, sharded_dalton_fused_batch_grad,
        sharded_basic_fused_batch_grad)
    from rodeo_tpu.ops import pallas_dalton, pallas_fenrir as pf
    from rodeo_tpu.models import lorenz as lz
    cfg = lz.setup(n_steps=40, t_max=0.4, dtype=jnp.float32)
    theta = cfg.pop("theta")
    B = 16
    thetas = jnp.broadcast_to(theta, (B, 3)) * \
        (1 + 1e-5 * jnp.arange(B, dtype=jnp.float32)[:, None])
    inits = jnp.broadcast_to(cfg["ode_init"], (B,) + cfg["ode_init"].shape)
    n_obs = 3
    obs_times = jnp.linspace(0.0, 0.4, n_obs).astype(jnp.float32)
    rng = np.random.default_rng(4)
    yobs = jnp.asarray(rng.normal(size=(n_obs, 3, 1)) * 3, jnp.float32)
    D = jnp.zeros((n_obs, 3, 1, 3), jnp.float32).at[:, :, :, 0].set(1.0)
    Om = 0.01 * jnp.broadcast_to(jnp.eye(1, dtype=jnp.float32),
                                 (n_obs, 3, 1, 1))
    base = dict(ode_weight=cfg["ode_weight"], ode_inits=inits,
                t_min=cfg["t_min"], t_max=cfg["t_max"],
                n_steps=cfg["n_steps"], prior_pars=cfg["prior_pars"],
                ode_flat=lz.lorenz_flat, jac_flat=lz.lorenz_jac_flat)
    obs = dict(obs_data=yobs, obs_times=obs_times, obs_weight=D,
               obs_var=Om)

    for sharded_fn, local_fn in (
            (sharded_fenrir_fused_batch_grad, pf.fenrir_fused_batch_grad),
            (sharded_dalton_fused_batch_grad,
             pallas_dalton.dalton_fused_batch_grad)):
        ll_s, g_s = sharded_fn(thetas=thetas, mesh=mesh, **obs, **base)
        ll_1, g_1 = local_fn(thetas=thetas, **obs, **base)
        assert g_s.shape == (B, 3)
        np.testing.assert_allclose(np.asarray(ll_s), np.asarray(ll_1),
                                   rtol=1e-5)
        np.testing.assert_allclose(np.asarray(g_s), np.asarray(g_1),
                                   rtol=1e-4, atol=1e-5)

    def b_loglik(obs_data, ode_data, **p):
        return jnp.sum(-0.5 * (obs_data[..., 0] - ode_data[..., 0]) ** 2)

    ll_s, g_s, mu_s = sharded_basic_fused_batch_grad(
        thetas=thetas, obs_data=yobs, obs_times=obs_times,
        obs_loglik=b_loglik, mesh=mesh, **base)
    ll_1, g_1, mu_1 = pallas_kalman.basic_fused_batch_grad(
        thetas=thetas, obs_data=yobs, obs_times=obs_times,
        obs_loglik=b_loglik, **base)
    np.testing.assert_allclose(np.asarray(ll_s), np.asarray(ll_1),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(g_s), np.asarray(g_1),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(mu_s), np.asarray(mu_1),
                               rtol=1e-5, atol=1e-5)


def test_mala_exact_on_gaussian():
    """MALA correctness on an analytic Gaussian target: the asymmetric
    proposal correction must make the chain exactly invariant — sampled
    moments converge to the target's."""
    from rodeo_tpu.parallel import make_mala_runner
    mu = jnp.array([1.0, -2.0], jnp.float32)
    var = jnp.array([0.5, 2.0], jnp.float32)

    def logpost_grad(pos):
        ll = -0.5 * jnp.sum((pos - mu) ** 2 / var, axis=-1)
        g = -(pos - mu) / var
        return ll, g

    n_lane, n_samp = 64, 400
    runner = make_mala_runner(logpost_grad, n_lane, n_samp, step_size=0.8)
    init = jnp.zeros((n_lane, 2), jnp.float32)
    positions, ll, acc = runner(init, jax.random.PRNGKey(0))
    assert positions.shape == (n_samp, n_lane, 2)
    a = float(jnp.mean(acc))
    assert 0.3 < a < 0.99, a
    draws = np.asarray(positions[n_samp // 2:]).reshape(-1, 2)
    np.testing.assert_allclose(draws.mean(0), np.asarray(mu), atol=0.1)
    np.testing.assert_allclose(draws.var(0), np.asarray(var), rtol=0.25)


def test_mala_fused_fenrir():
    """Lockstep MALA over the tangent-augmented fused fenrir kernels:
    runs, accepts, and the chains move from a perturbed start toward
    higher posterior density."""
    from rodeo_tpu.parallel import run_chains_mala_fused
    from rodeo_tpu.models import fitzhugh
    cfg = fitzhugh.setup(n_steps=50, t_max=2.0, dtype=jnp.float32)
    theta = cfg.pop("theta")
    n_obs = 5
    obs_times = jnp.linspace(0.0, 2.0, n_obs).astype(jnp.float32)
    rng = np.random.default_rng(9)
    yobs = jnp.asarray(rng.normal(size=(n_obs, 2, 1)) * 0.5, jnp.float32)
    D = jnp.zeros((n_obs, 2, 1, 3), jnp.float32).at[:, :, :, 0].set(1.0)
    Om = 0.04 * jnp.broadcast_to(jnp.eye(1, dtype=jnp.float32),
                                 (n_obs, 2, 1, 1))
    n_lane, n_samp = 8, 10
    init = jnp.broadcast_to(theta * 1.2, (n_lane, 3)).astype(jnp.float32)
    positions, ll, acc = run_chains_mala_fused(
        init, jax.random.PRNGKey(1), n_samples=n_samp, step_size=0.005,
        ode_weight=cfg["ode_weight"], ode_init=cfg["ode_init"],
        t_min=cfg["t_min"], t_max=cfg["t_max"], n_steps=cfg["n_steps"],
        prior_pars=cfg["prior_pars"], obs_data=yobs, obs_times=obs_times,
        obs_weight=D, obs_var=Om, ode_flat=fitzhugh.fitzhugh_flat,
        jac_flat=fitzhugh.fitzhugh_jac_flat)
    assert positions.shape == (n_samp, n_lane, 3)
    assert bool(jnp.all(jnp.isfinite(ll)))
    assert float(jnp.mean(acc)) > 0.0
    assert bool(jnp.any(positions[-1] != init))


def test_sharded_magi_fused_batch(mesh):
    from rodeo_tpu.parallel.fused import sharded_magi_fused_batch
    from rodeo_tpu.ops import pallas_magi
    cfg = fitzhugh.setup(n_steps=64, t_max=2.0, dtype=jnp.float32)
    cfg.pop("theta")
    dt = 2.0 / 64
    B = 16
    rng = np.random.default_rng(5)
    n_block = cfg["ode_init"].shape[0]
    base = jnp.asarray(rng.normal(size=(65, n_block, 2)), jnp.float32)

    def ode_expand(u, **p):
        pad = jnp.zeros(u.shape[:-1] + (1,), u.dtype)
        return jnp.concatenate([u, pad], axis=-1)

    subsets = jnp.stack([
        base + 0.1 * i * jnp.asarray(
            rng.normal(size=base.shape), jnp.float32) for i in range(B)])
    sig2 = jnp.linspace(0.5, 2.0, B)
    ll_s = sharded_magi_fused_batch(
        subsets, ode_expand, 2, cfg["prior_pars"], dt,
        sig2_lanes=sig2, mesh=mesh)
    ll_1 = pallas_magi.magi_fused_batch(
        subsets, ode_expand, 2, cfg["prior_pars"], dt, sig2_lanes=sig2)
    assert ll_s.shape == (B,)
    np.testing.assert_allclose(np.asarray(ll_s), np.asarray(ll_1),
                               rtol=1e-5)


def test_sharded_magi_fused_batch_grad(mesh):
    from rodeo_tpu.parallel.fused import sharded_magi_fused_batch_grad
    from rodeo_tpu.ops import pallas_magi
    cfg = fitzhugh.setup(n_steps=64, t_max=2.0, dtype=jnp.float32)
    cfg.pop("theta")
    dt = 2.0 / 64
    B = 16
    rng = np.random.default_rng(9)
    n_block = cfg["ode_init"].shape[0]
    base = jnp.asarray(rng.normal(size=(65, n_block, 2)), jnp.float32)

    def ode_expand(u, **p):
        pad = jnp.zeros(u.shape[:-1] + (1,), u.dtype)
        return jnp.concatenate([u, pad], axis=-1)

    subsets = jnp.stack([
        base + 0.1 * i * jnp.asarray(
            rng.normal(size=base.shape), jnp.float32) for i in range(B)])
    ld_s, g_s = sharded_magi_fused_batch_grad(
        subsets, ode_expand, 2, cfg["prior_pars"], dt, mesh=mesh)
    ld_1, g_1 = pallas_magi.magi_fused_batch_grad(
        subsets, ode_expand, 2, cfg["prior_pars"], dt)
    assert ld_s.shape == (B,) and g_s.shape == subsets.shape
    np.testing.assert_allclose(np.asarray(ld_s), np.asarray(ld_1),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(g_s), np.asarray(g_1),
                               rtol=1e-4, atol=1e-5)


def test_run_chains_mala_magi():
    """Path-space MALA over the fused MAGI adjoint: runs, accepts, and
    improves (or keeps) the posterior logdens from a rough init."""
    from rodeo_tpu.parallel import run_chains_mala_magi
    cfg = fitzhugh.setup(n_steps=32, t_max=2.0, dtype=jnp.float32)
    cfg.pop("theta")
    dt = 2.0 / 32
    B = 4
    rng = np.random.default_rng(2)
    n_block = cfg["ode_init"].shape[0]
    base = jnp.asarray(rng.normal(size=(33, n_block, 2)), jnp.float32)

    def ode_expand(u, **p):
        pad = jnp.zeros(u.shape[:-1] + (1,), u.dtype)
        return jnp.concatenate([u, pad], axis=-1)

    subsets = jnp.stack([
        base + 0.05 * i * jnp.asarray(
            rng.normal(size=base.shape), jnp.float32) for i in range(B)])

    # fake observations of the first coordinate + a Gaussian obs model
    yobs = base[::8, :, 0]

    def extra_grad_fn(position):
        def obs_ll(u):
            r = u[:, ::8, :, 0] - yobs
            return -0.5 * jnp.sum(r * r, axis=(1, 2)) / 0.04
        ll, vjp = jax.vjp(obs_ll, position)
        g = vjp(jnp.ones_like(ll))[0]
        return ll, g

    import jax
    positions, ld, acc = run_chains_mala_magi(
        subsets, jax.random.PRNGKey(0), n_samples=10, step_size=1e-6,
        ode_expand=ode_expand, n_active=2, prior_pars=cfg["prior_pars"],
        dt=dt, extra_grad_fn=extra_grad_fn)
    assert positions.shape == (10, B, 33, n_block, 2)
    assert ld.shape == (B,) and np.all(np.isfinite(np.asarray(ld)))
    assert float(jnp.max(acc)) > 0.0

    # joint (U, theta) position: theta enters through ode_expand
    def expand_th(u, theta, **p):
        return jnp.concatenate(
            [u[..., :1], theta[..., None, None, None] * u[..., 1:2],
             jnp.zeros_like(u[..., :1])], axis=-1)

    thetas0 = jnp.ones((B,), jnp.float32)
    (pos_u, pos_th), ld2, acc2 = run_chains_mala_magi(
        subsets, jax.random.PRNGKey(1), n_samples=5, step_size=1e-6,
        ode_expand=expand_th, n_active=2, prior_pars=cfg["prior_pars"],
        dt=dt, theta_lanes=thetas0)
    assert pos_u.shape == (5, B, 33, n_block, 2)
    assert pos_th.shape == (5, B)
    assert np.all(np.isfinite(np.asarray(ld2)))


def test_hmc_exact_on_gaussian():
    """HMC correctness on an analytic anisotropic Gaussian: leapfrog +
    the Metropolis correction on Delta-H must leave the target exactly
    invariant — sampled moments converge to the target's, and on a
    smooth target acceptance should be near 1."""
    from rodeo_tpu.parallel import make_hmc_runner
    mu = jnp.array([1.0, -2.0], jnp.float32)
    var = jnp.array([0.5, 2.0], jnp.float32)

    def logpost_grad(pos):
        ll = -0.5 * jnp.sum((pos - mu) ** 2 / var, axis=-1)
        g = -(pos - mu) / var
        return ll, g

    n_lane, n_samp = 64, 200
    runner = make_hmc_runner(logpost_grad, n_lane, n_samp,
                             step_size=jnp.sqrt(var) * 0.5, n_leapfrog=8)
    init = jnp.zeros((n_lane, 2), jnp.float32)
    positions, ll, acc = runner(init, jax.random.PRNGKey(0))
    assert positions.shape == (n_samp, n_lane, 2)
    a = float(jnp.mean(acc))
    assert a > 0.8, a
    draws = np.asarray(positions[n_samp // 2:]).reshape(-1, 2)
    np.testing.assert_allclose(draws.mean(0), np.asarray(mu), atol=0.1)
    np.testing.assert_allclose(draws.var(0), np.asarray(var), rtol=0.25)


def test_hmc_fused_fenrir():
    """Lockstep HMC over the tangent-augmented fused fenrir kernels:
    runs, accepts, and the chains move."""
    from rodeo_tpu.parallel import run_chains_hmc_fused
    cfg = fitzhugh.setup(n_steps=50, t_max=2.0, dtype=jnp.float32)
    theta = cfg.pop("theta")
    n_obs = 5
    obs_times = jnp.linspace(0.0, 2.0, n_obs).astype(jnp.float32)
    rng = np.random.default_rng(9)
    yobs = jnp.asarray(rng.normal(size=(n_obs, 2, 1)) * 0.5, jnp.float32)
    D = jnp.zeros((n_obs, 2, 1, 3), jnp.float32).at[:, :, :, 0].set(1.0)
    Om = 0.04 * jnp.broadcast_to(jnp.eye(1, dtype=jnp.float32),
                                 (n_obs, 2, 1, 1))
    n_lane, n_samp = 8, 5
    init = jnp.broadcast_to(theta * 1.2, (n_lane, 3)).astype(jnp.float32)
    positions, ll, acc = run_chains_hmc_fused(
        init, jax.random.PRNGKey(1), n_samples=n_samp, step_size=0.002,
        n_leapfrog=3,
        ode_weight=cfg["ode_weight"], ode_init=cfg["ode_init"],
        t_min=cfg["t_min"], t_max=cfg["t_max"], n_steps=cfg["n_steps"],
        prior_pars=cfg["prior_pars"], obs_data=yobs, obs_times=obs_times,
        obs_weight=D, obs_var=Om, ode_flat=fitzhugh.fitzhugh_flat,
        jac_flat=fitzhugh.fitzhugh_jac_flat)
    assert positions.shape == (n_samp, n_lane, 3)
    assert bool(jnp.all(jnp.isfinite(ll)))
    assert float(jnp.mean(acc)) > 0.0
    assert bool(jnp.any(positions[-1] != init))


def test_hmc_magi_pathspace():
    """Path-space HMC over the fused MAGI adjoint, including the joint
    (U, theta) pytree position."""
    from rodeo_tpu.parallel import run_chains_hmc_magi
    cfg = fitzhugh.setup(n_steps=32, t_max=2.0, dtype=jnp.float32)
    cfg.pop("theta")
    dt = 2.0 / 32
    B = 4
    rng = np.random.default_rng(2)
    n_block = cfg["ode_init"].shape[0]
    base = jnp.asarray(rng.normal(size=(33, n_block, 2)), jnp.float32)

    def ode_expand(u, **p):
        pad = jnp.zeros(u.shape[:-1] + (1,), u.dtype)
        return jnp.concatenate([u, pad], axis=-1)

    subsets = jnp.stack([
        base + 0.05 * i * jnp.asarray(
            rng.normal(size=base.shape), jnp.float32) for i in range(B)])
    positions, ld, acc = run_chains_hmc_magi(
        subsets, jax.random.PRNGKey(0), n_samples=5, step_size=1e-6,
        n_leapfrog=2, ode_expand=ode_expand, n_active=2,
        prior_pars=cfg["prior_pars"], dt=dt)
    assert positions.shape == (5, B, 33, n_block, 2)
    assert ld.shape == (B,) and np.all(np.isfinite(np.asarray(ld)))

    def expand_th(u, theta, **p):
        return jnp.concatenate(
            [u[..., :1], theta[..., None, None, None] * u[..., 1:2],
             jnp.zeros_like(u[..., :1])], axis=-1)

    thetas0 = jnp.ones((B,), jnp.float32)
    (pos_u, pos_th), ld2, acc2 = run_chains_hmc_magi(
        subsets, jax.random.PRNGKey(1), n_samples=3, step_size=1e-6,
        n_leapfrog=2, ode_expand=expand_th, n_active=2,
        prior_pars=cfg["prior_pars"], dt=dt, theta_lanes=thetas0)
    assert pos_u.shape == (3, B, 33, n_block, 2)
    assert pos_th.shape == (3, B)
    assert np.all(np.isfinite(np.asarray(ld2)))


def test_adapt_step_size():
    """Dual-averaging adaptation drives MALA and HMC acceptance toward
    their targets on an analytic Gaussian, starting from a badly
    mis-scaled step."""
    from rodeo_tpu.parallel import (make_mala_runner, make_hmc_runner,
                                    adapt_step_size)
    mu = jnp.array([0.0, 0.0], jnp.float32)
    var = jnp.array([1.0, 1.0], jnp.float32)

    def logpost_grad(pos):
        ll = -0.5 * jnp.sum((pos - mu) ** 2 / var, axis=-1)
        g = -(pos - mu) / var
        return ll, g

    n_lane = 64
    init = jnp.zeros((n_lane, 2), jnp.float32)

    runner_m = make_mala_runner(logpost_grad, n_lane, 48, step_size=1.0)
    eps_m, pos_m, acc_m = adapt_step_size(
        runner_m, init, jax.random.PRNGKey(0), init_step=20.0,
        target_accept=0.57, n_windows=15)
    assert 0.35 < acc_m < 0.8, (float(jnp.ravel(eps_m)[0]), acc_m)
    assert jax.tree.leaves(pos_m)[0].shape == (n_lane, 2)

    runner_h = make_hmc_runner(logpost_grad, n_lane, 48, step_size=1.0,
                               n_leapfrog=5)
    eps_h, pos_h, acc_h = adapt_step_size(
        runner_h, init, jax.random.PRNGKey(1), init_step=0.001,
        target_accept=0.8, n_windows=15)
    assert 0.6 < acc_h <= 1.0, (float(jnp.ravel(eps_h)[0]), acc_h)
    # from a 1000x-too-small start the tuner must have grown the step
    assert float(jnp.ravel(eps_h)[0]) > 0.01


def test_magi_sig2_quadform_exact():
    """The two-point (Q, D) recovery must reproduce the MAGI log-density
    at ANY third sigma^2 — validating the exact -Q/2s - (D/2)ln s + C
    functional form the Gibbs move relies on."""
    from rodeo_tpu.ops.pallas_magi import magi_fused_batch
    from rodeo_tpu.parallel import magi_sig2_quadform
    cfg = fitzhugh.setup(n_steps=32, t_max=2.0, dtype=jnp.float32)
    cfg.pop("theta")
    dt = 2.0 / 32
    B = 3
    n_block = cfg["ode_init"].shape[0]
    # near-ODE paths keep Q at O(D) so f32 resolves the log term
    from rodeo_tpu.interrogate import interrogate_kramer
    from rodeo_tpu.ops import precond
    cfg64 = fitzhugh.setup(n_steps=32, t_max=2.0, dtype=jnp.float32)
    th = cfg64.pop("theta")
    mu, _ = precond.solve_mv(key=None, interrogate=interrogate_kramer,
                             theta=th, **cfg64)

    def ode_expand(u, **p):
        pad = jnp.zeros(u.shape[:-1] + (1,), u.dtype)
        return jnp.concatenate([u, pad], axis=-1)

    subsets = jnp.stack([mu[:, :, :2] * (1.0 + 0.01 * i)
                         for i in range(B)]).astype(jnp.float32)
    s = jnp.full((B,), 1.5, jnp.float32)

    def ld_at(mult):
        return magi_fused_batch(subsets, ode_expand, 2,
                                cfg["prior_pars"], dt,
                                sig2_lanes=mult)

    ld_s, ld_2s = ld_at(s), ld_at(2.0 * s)
    q, d_dim = magi_sig2_quadform(ld_s, ld_2s, s, 32, n_block, 2)
    assert d_dim == 32 * n_block * 2
    # predict at s' = 3s from (Q, D, C) and compare to a real evaluation
    c = ld_s + q / (2.0 * s) + 0.5 * d_dim * jnp.log(s)
    sp = 3.0 * s
    pred = -q / (2.0 * sp) - 0.5 * d_dim * jnp.log(sp) + c
    real = ld_at(sp)
    np.testing.assert_allclose(np.asarray(pred), np.asarray(real),
                               rtol=1e-4, atol=0.5)


def test_run_chains_magi_gibbs():
    """Joint (U, sigma^2) MAGI sampler: runs, stays finite, sigma^2
    draws vary lane-to-lane and sweep-to-sweep, and with a dominant
    InvGamma prior the draws concentrate near the prior mean."""
    from rodeo_tpu.parallel import run_chains_magi_gibbs
    cfg = fitzhugh.setup(n_steps=32, t_max=2.0, dtype=jnp.float32)
    cfg.pop("theta")
    dt = 2.0 / 32
    B = 4
    rng = np.random.default_rng(4)
    n_block = cfg["ode_init"].shape[0]
    base = jnp.asarray(rng.normal(size=(33, n_block, 2)) * 0.1,
                       jnp.float32)
    subsets = jnp.stack([base + 0.02 * i for i in range(B)])
    positions, sig2s, ld, acc = run_chains_magi_gibbs(
        subsets, jax.random.PRNGKey(0), n_sweeps=4, step_size=1e-6,
        ode_expand=lambda u, **p: jnp.concatenate(
            [u, jnp.zeros(u.shape[:-1] + (1,), u.dtype)], axis=-1),
        n_active=2, prior_pars=cfg["prior_pars"], dt=dt,
        sig2_init=1.0, n_inner=2)
    assert positions.shape == (4, B, 33, n_block, 2)
    assert sig2s.shape == (4, B)
    assert np.all(np.isfinite(np.asarray(sig2s)))
    assert np.all(np.asarray(sig2s) > 0)
    assert np.all(np.isfinite(np.asarray(ld)))
    # draws actually move
    assert float(jnp.std(sig2s)) > 0


def test_runner_validation():
    from rodeo_tpu.parallel import make_hmc_runner, run_chains_magi_gibbs

    def lp(pos):
        return -0.5 * jnp.sum(pos ** 2, -1), -pos

    with pytest.raises(ValueError, match="n_leapfrog"):
        make_hmc_runner(lp, 4, 10, 0.1, n_leapfrog=0)
    with pytest.raises(ValueError, match="n_inner"):
        run_chains_magi_gibbs(
            jnp.zeros((2, 9, 1, 2)), jax.random.PRNGKey(0), 2, 1e-6,
            ode_expand=lambda u, **p: u, n_active=2,
            prior_pars=(jnp.zeros((1, 2, 2)), jnp.eye(2)[None]),
            dt=0.1, sig2_init=1.0, n_inner=0)


def test_nuts_fused_fenrir():
    """Lockstep NUTS over the tangent-augmented fused fenrir kernels:
    runs, stays finite, and the chains move."""
    from rodeo_tpu.parallel import run_chains_nuts_fused
    cfg = fitzhugh.setup(n_steps=50, t_max=2.0, dtype=jnp.float32)
    theta = cfg.pop("theta")
    n_obs = 5
    obs_times = jnp.linspace(0.0, 2.0, n_obs).astype(jnp.float32)
    rng = np.random.default_rng(10)
    yobs = jnp.asarray(rng.normal(size=(n_obs, 2, 1)) * 0.5, jnp.float32)
    D = jnp.zeros((n_obs, 2, 1, 3), jnp.float32).at[:, :, :, 0].set(1.0)
    Om = 0.04 * jnp.broadcast_to(jnp.eye(1, dtype=jnp.float32),
                                 (n_obs, 2, 1, 1))
    n_lane, n_samp = 8, 3
    init = jnp.broadcast_to(theta * 1.2, (n_lane, 3)).astype(jnp.float32)
    positions, ll, acc = run_chains_nuts_fused(
        init, jax.random.PRNGKey(1), n_samples=n_samp, step_size=0.002,
        max_depth=2,
        ode_weight=cfg["ode_weight"], ode_init=cfg["ode_init"],
        t_min=cfg["t_min"], t_max=cfg["t_max"], n_steps=cfg["n_steps"],
        prior_pars=cfg["prior_pars"], obs_data=yobs, obs_times=obs_times,
        obs_weight=D, obs_var=Om, ode_flat=fitzhugh.fitzhugh_flat,
        jac_flat=fitzhugh.fitzhugh_jac_flat)
    assert positions.shape == (n_samp, n_lane, 3)
    assert bool(jnp.all(jnp.isfinite(ll)))
    assert bool(jnp.all(jnp.isfinite(positions)))
    assert bool(jnp.any(positions[-1] != init))


def test_nuts_magi_pathspace():
    """Path-space NUTS over the fused MAGI adjoint, including the joint
    (U, theta) pytree position."""
    from rodeo_tpu.parallel import run_chains_nuts_magi
    cfg = fitzhugh.setup(n_steps=32, t_max=2.0, dtype=jnp.float32)
    cfg.pop("theta")
    dt = 2.0 / 32
    B = 4
    rng = np.random.default_rng(3)
    n_block = cfg["ode_init"].shape[0]
    base = jnp.asarray(rng.normal(size=(33, n_block, 2)), jnp.float32)

    def ode_expand(u, **p):
        pad = jnp.zeros(u.shape[:-1] + (1,), u.dtype)
        return jnp.concatenate([u, pad], axis=-1)

    subsets = jnp.stack([
        base + 0.05 * i * jnp.asarray(
            rng.normal(size=base.shape), jnp.float32) for i in range(B)])
    positions, ld, acc = run_chains_nuts_magi(
        subsets, jax.random.PRNGKey(0), n_samples=3, step_size=1e-6,
        max_depth=2, ode_expand=ode_expand, n_active=2,
        prior_pars=cfg["prior_pars"], dt=dt)
    assert positions.shape == (3, B, 33, n_block, 2)
    assert ld.shape == (B,) and np.all(np.isfinite(np.asarray(ld)))

    thetas0 = jnp.ones((B,), jnp.float32)

    def expand_th(u, theta, **p):
        return jnp.concatenate(
            [u[..., :1], theta[..., None, None, None] * u[..., 1:2],
             jnp.zeros_like(u[..., :1])], axis=-1)

    (pos_u, pos_th), ld2, acc2 = run_chains_nuts_magi(
        subsets, jax.random.PRNGKey(1), n_samples=2, step_size=1e-6,
        max_depth=2, ode_expand=expand_th, n_active=2,
        prior_pars=cfg["prior_pars"], dt=dt, theta_lanes=thetas0)
    assert pos_u.shape == (2, B, 33, n_block, 2)
    assert pos_th.shape == (2, B)
    assert np.all(np.isfinite(np.asarray(ld2)))
