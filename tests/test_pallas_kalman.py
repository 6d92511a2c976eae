"""
Fused step-function tests (the scan driver on CPU): solve_mv_fused must
match the preconditioned covariance solver.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rodeo_tpu.ops import precond, pallas_kalman
from rodeo_tpu.interrogate import interrogate_kramer, interrogate_rodeo
from rodeo_tpu.models import lorenz


@pytest.fixture(scope="module")
def lorenz_cfg():
    cfg = lorenz.setup(n_steps=200, t_max=2.0, dtype=jnp.float32)
    theta = cfg.pop("theta")
    return cfg, theta


def test_fused_matches_precond_kramer(lorenz_cfg):
    cfg, theta = lorenz_cfg
    mu_ref, var_ref = precond.solve_mv(
        key=None, interrogate=interrogate_kramer, theta=theta, **cfg)
    mu_f, var_f = pallas_kalman.solve_mv_fused(
        key=None, interrogate=interrogate_kramer, theta=theta,
        ode_flat=lorenz.lorenz_flat, jac_flat=lorenz.lorenz_jac_flat, **cfg)
    assert not bool(jnp.any(jnp.isnan(mu_f)))
    m, mr = np.asarray(mu_f[:, :, 0]), np.asarray(mu_ref[:, :, 0])
    np.testing.assert_allclose(m, mr, rtol=2e-3, atol=2e-3)
    v, vr = np.asarray(var_f), np.asarray(var_ref)
    scale = np.abs(vr).max()
    np.testing.assert_allclose(v / scale, vr / scale, atol=1e-4)


def test_fused_matches_precond_rodeo(lorenz_cfg):
    """jac_flat=None selects the zero-order (rodeo) interrogation."""
    cfg, theta = lorenz_cfg
    mu_ref, var_ref = precond.solve_mv(
        key=None, interrogate=interrogate_rodeo, theta=theta, **cfg)
    mu_f, var_f = pallas_kalman.solve_mv_fused(
        key=None, interrogate=interrogate_rodeo, theta=theta,
        ode_flat=lorenz.lorenz_flat, jac_flat=None, **cfg)
    assert not bool(jnp.any(jnp.isnan(mu_f)))
    m, mr = np.asarray(mu_f[:, :, 0]), np.asarray(mu_ref[:, :, 0])
    np.testing.assert_allclose(m, mr, rtol=2e-3, atol=2e-3)


def test_fused_jittable(lorenz_cfg):
    cfg, theta = lorenz_cfg
    fn = jax.jit(lambda th: pallas_kalman.solve_mv_fused(
        key=None, interrogate=interrogate_kramer, theta=th,
        ode_flat=lorenz.lorenz_flat, jac_flat=lorenz.lorenz_jac_flat,
        **cfg))
    mu1, _ = fn(theta)
    mu2, _ = pallas_kalman.solve_mv_fused(
        key=None, interrogate=interrogate_kramer, theta=theta,
        ode_flat=lorenz.lorenz_flat, jac_flat=lorenz.lorenz_jac_flat, **cfg)
    # jit changes op fusion -> f32 rounding differences, which the
    # zero-noise filter recursion amplifies ~1e-2 over 200 Lorenz steps
    np.testing.assert_allclose(mu1, mu2, rtol=5e-2, atol=5e-2)


def test_jvp_jac_matches_analytic():
    """Generic jvp-based block-diagonal Jacobian == hand-written one."""
    from rodeo_tpu.models import fitzhugh
    th = jnp.array([[0.2], [0.2], [3.0]], jnp.float32)
    x_cols = [jnp.array([[0.3], [-0.8]], jnp.float32),
              jnp.zeros((2, 1), jnp.float32),
              jnp.zeros((2, 1), jnp.float32)]
    jac_auto = pallas_kalman.jvp_jac_flat(fitzhugh.fitzhugh_flat, 2, 3)
    cols_auto = jac_auto(x_cols, th, 0.0)
    cols_hand = fitzhugh.fitzhugh_jac_flat(x_cols, th, 0.0)
    np.testing.assert_allclose(cols_auto[0], cols_hand[0], rtol=1e-6)
    for j in (1, 2):
        assert cols_hand[j] is None
        np.testing.assert_allclose(cols_auto[j], 0.0, atol=1e-7)


def test_fused_with_jvp_jacobian(lorenz_cfg):
    """solve_mv_fused with the generic jvp Jacobian matches the analytic
    one."""
    cfg, theta = lorenz_cfg
    jac_auto = pallas_kalman.jvp_jac_flat(lorenz.lorenz_flat, 3, 3)
    mu_a, _ = pallas_kalman.solve_mv_fused(
        key=None, interrogate=None, theta=theta,
        ode_flat=lorenz.lorenz_flat, jac_flat=jac_auto, **cfg)
    mu_h, _ = pallas_kalman.solve_mv_fused(
        key=None, interrogate=None, theta=theta,
        ode_flat=lorenz.lorenz_flat, jac_flat=lorenz.lorenz_jac_flat, **cfg)
    # same f32 rounding-amplification allowance as test_fused_jittable
    np.testing.assert_allclose(mu_a, mu_h, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("model_name", ["hes1", "seirah"])
def test_fused_other_models(model_name):
    """Fused solver (jvp Jacobian) matches the preconditioned solver on the
    remaining benchmark systems."""
    import importlib
    model = importlib.import_module(f"rodeo_tpu.models.{model_name}")
    cfg = model.setup(n_steps=40, t_max=model.setup()["t_max"] / 4,
                      dtype=jnp.float32)
    theta = cfg.pop("theta")
    mu_ref, _ = precond.solve_mv(
        key=None, interrogate=interrogate_kramer, theta=theta, **cfg)
    ode_flat = getattr(model, f"{model_name}_flat")
    n_block = cfg["ode_weight"].shape[0]
    jac = pallas_kalman.jvp_jac_flat(ode_flat, n_block, 3)
    mu_f, _ = pallas_kalman.solve_mv_fused(
        key=None, interrogate=None, theta=theta,
        ode_flat=ode_flat, jac_flat=jac, **cfg)
    assert not bool(jnp.any(jnp.isnan(mu_f)))
    m, mr = np.asarray(mu_f[:, :, 0]), np.asarray(mu_ref[:, :, 0])
    np.testing.assert_allclose(m, mr, rtol=2e-2, atol=2e-2 * np.abs(mr).max())


def test_sym_inv_q45():
    """Blocked Schur-complement closed-form inverse for q = 4, 5."""
    rng = np.random.default_rng(12)
    for q in (4, 5):
        pairs, _ = pallas_kalman._tri_idx(q)
        a = rng.standard_normal((7, q, q))
        m = a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(q)
        m *= 10.0 ** rng.integers(-6, 6, size=(7, 1, 1))
        p_cols = [jnp.asarray(m[:, i, j]) for (i, j) in pairs]
        inv_cols = pallas_kalman._sym_inv(q, p_cols)
        inv = np.zeros_like(m)
        for k, (i, j) in enumerate(pairs):
            inv[:, i, j] = inv[:, j, i] = np.asarray(inv_cols[k])
        ref = np.linalg.inv(m)
        np.testing.assert_allclose(inv / np.abs(ref).max(),
                                   ref / np.abs(ref).max(), atol=1e-10)


def test_fused_q4_chkrebtii():
    """q=4 higher-order ODE (the reference's Chkrebtii d*p=4 benchmark,
    `/root/reference/examples/timings.py:104-169`) rides the fused path
    and matches the preconditioned XLA solver."""
    from rodeo_tpu.models import chkrebtii
    cfg = chkrebtii.setup(n_steps=40, dtype=jnp.float32)
    cfg.pop("theta")
    mu_ref, var_ref = precond.solve_mv(
        key=None, interrogate=interrogate_kramer, **cfg)
    mu_f, var_f = pallas_kalman.solve_mv_fused(
        key=None, interrogate=None,
        ode_flat=chkrebtii.chkrebtii_flat,
        jac_flat=chkrebtii.chkrebtii_jac_flat, **cfg)
    assert not bool(jnp.any(jnp.isnan(mu_f)))
    np.testing.assert_allclose(
        np.asarray(mu_f[:, :, 0]), np.asarray(mu_ref[:, :, 0]),
        rtol=2e-3, atol=2e-3)
    # lane-batched variant
    B = 3
    inits = jnp.broadcast_to(cfg["ode_init"], (B,) + cfg["ode_init"].shape)
    mu_b, var_b = pallas_kalman.solve_mv_fused_batch(
        thetas=jnp.zeros((B, 1), jnp.float32),
        ode_weight=cfg["ode_weight"], ode_inits=inits,
        t_min=cfg["t_min"], t_max=cfg["t_max"], n_steps=cfg["n_steps"],
        prior_pars=cfg["prior_pars"],
        ode_flat=chkrebtii.chkrebtii_flat,
        jac_flat=chkrebtii.chkrebtii_jac_flat)
    assert mu_b.shape == (cfg["n_steps"] + 1, 1, 4, B)
    for i in range(B):
        np.testing.assert_allclose(
            np.asarray(mu_b[:, :, 0, i]), np.asarray(mu_ref[:, :, 0]),
            rtol=2e-3, atol=2e-3)


def test_fused_batch_schober_mode():
    """interrogation='schober' (zero-order, zero noise) matches the XLA
    preconditioned solver with interrogate_schober."""
    from rodeo_tpu.interrogate import interrogate_schober
    cfg = lorenz.setup(n_steps=200, t_max=2.0, dtype=jnp.float32)
    theta = cfg.pop("theta")
    B = 4
    thetas = jnp.broadcast_to(theta, (B, 3))
    inits = jnp.broadcast_to(cfg["ode_init"], (B,) + cfg["ode_init"].shape)
    mu_s, _ = pallas_kalman.solve_mv_fused_batch(
        interrogation="schober", thetas=thetas,
        ode_weight=cfg["ode_weight"], ode_inits=inits,
        t_min=cfg["t_min"], t_max=cfg["t_max"], n_steps=cfg["n_steps"],
        prior_pars=cfg["prior_pars"], ode_flat=lorenz.lorenz_flat)
    mu_ref, _ = precond.solve_mv(
        key=None, interrogate=interrogate_schober, theta=theta, **cfg)
    np.testing.assert_allclose(
        np.asarray(mu_s[..., 0]), np.asarray(mu_ref), rtol=5e-2, atol=5e-2)


def test_fused_batch_chkrebtii_mode():
    """interrogation='chkrebtii' (stochastic, in-kernel predictive draw)
    matches the XLA chkrebtii interrogation distributionally: same
    mean-of-realizations and same realization spread."""
    from functools import partial
    import rodeo_tpu
    from rodeo_tpu.interrogate import interrogate_chkrebtii
    from rodeo_tpu.models import fitzhugh
    cfg = fitzhugh.setup(n_steps=100, t_max=5.0, dtype=jnp.float32)
    theta = cfg.pop("theta")
    B = 16
    thetas = jnp.broadcast_to(theta, (B, 3))
    inits = jnp.broadcast_to(cfg["ode_init"], (B,) + cfg["ode_init"].shape)
    mu_c, _ = pallas_kalman.solve_mv_fused_batch(
        interrogation="chkrebtii", key=jax.random.PRNGKey(0),
        thetas=thetas, ode_weight=cfg["ode_weight"], ode_inits=inits,
        t_min=cfg["t_min"], t_max=cfg["t_max"], n_steps=cfg["n_steps"],
        prior_pars=cfg["prior_pars"], ode_flat=fitzhugh.fitzhugh_flat)
    assert bool(jnp.all(jnp.isfinite(mu_c)))
    cfg64 = fitzhugh.setup(n_steps=100, t_max=5.0, dtype=jnp.float64)
    cfg64.pop("theta")
    xla = jnp.stack([
        rodeo_tpu.solve_mv(
            key=jax.random.PRNGKey(100 + s),
            interrogate=partial(interrogate_chkrebtii,
                                kalman_type="standard"),
            theta=theta.astype(jnp.float64), **cfg64)[0][:, :, 0]
        for s in range(16)])
    mean_diff = float(jnp.max(jnp.abs(
        jnp.mean(mu_c[:, :, 0, :], axis=-1) - jnp.mean(xla, axis=0))))
    sd_fused = float(jnp.mean(jnp.std(mu_c[:, :, 0, :], axis=-1)))
    sd_xla = float(jnp.mean(jnp.std(xla, axis=0)))
    assert mean_diff < 1e-2, mean_diff
    assert 0.5 < sd_fused / sd_xla < 2.0, (sd_fused, sd_xla)


def test_fenrir_fused_matches_xla():
    """Fused fenrir likelihood == XLA fenrir (f32)."""
    import importlib
    from rodeo_tpu.ops import pallas_fenrir
    fen = importlib.import_module("rodeo_tpu.inference.fenrir")
    cfg = lorenz.setup(n_steps=400, t_max=4.0, dtype=jnp.float32)
    theta = cfg.pop("theta")
    rng = np.random.default_rng(5)
    n_obs = 9
    obs_times = jnp.linspace(0.0, 4.0, n_obs).astype(jnp.float32)
    D = jnp.zeros((n_obs, 3, 1, 3), jnp.float32).at[:, :, :, 0].set(1.0)
    Om = 0.01 * jnp.broadcast_to(jnp.eye(1, dtype=jnp.float32),
                                 (n_obs, 3, 1, 1))
    yobs = jnp.asarray(rng.normal(size=(n_obs, 3, 1)) * 3,
                       dtype=jnp.float32)
    kw = dict(key=None, interrogate=interrogate_kramer, theta=theta,
              obs_data=yobs, obs_times=obs_times, obs_weight=D, obs_var=Om)
    ll_fused = pallas_fenrir.fenrir_fused(
        ode_flat=lorenz.lorenz_flat, jac_flat=lorenz.lorenz_jac_flat,
        **kw, **cfg)
    from rodeo_tpu.ops import precond
    ll_xla = precond.fenrir(**kw, **cfg)
    np.testing.assert_allclose(float(ll_fused), float(ll_xla),
                               rtol=2e-3)


def test_fenrir_fused_no_obs_at_terminal():
    """Observations not touching t=0 or t=N still work."""
    import importlib
    from rodeo_tpu.ops import pallas_fenrir, precond
    cfg = lorenz.setup(n_steps=200, t_max=2.0, dtype=jnp.float32)
    theta = cfg.pop("theta")
    rng = np.random.default_rng(6)
    obs_times = jnp.asarray([0.5, 1.0, 1.5], jnp.float32)
    n_obs = 3
    D = jnp.zeros((n_obs, 3, 1, 3), jnp.float32).at[:, :, :, 0].set(1.0)
    Om = 0.01 * jnp.broadcast_to(jnp.eye(1, dtype=jnp.float32),
                                 (n_obs, 3, 1, 1))
    yobs = jnp.asarray(rng.normal(size=(n_obs, 3, 1)) * 3, jnp.float32)
    kw = dict(key=None, interrogate=interrogate_kramer, theta=theta,
              obs_data=yobs, obs_times=obs_times, obs_weight=D, obs_var=Om)
    ll_fused = pallas_fenrir.fenrir_fused(
        ode_flat=lorenz.lorenz_flat, jac_flat=lorenz.lorenz_jac_flat,
        **kw, **cfg)
    ll_xla = precond.fenrir(**kw, **cfg)
    np.testing.assert_allclose(float(ll_fused), float(ll_xla), rtol=2e-3)


def test_solve_mv_fused_batch_matches_single(lorenz_cfg):
    """Lane-batched fused solve == per-lane single fused solves."""
    cfg, theta = lorenz_cfg
    B = 4
    thetas = jnp.stack([theta * (1.0 + 0.01 * i) for i in range(B)])
    ode_inits = jnp.broadcast_to(cfg["ode_init"],
                                 (B,) + cfg["ode_init"].shape)
    mu_b, var_b = pallas_kalman.solve_mv_fused_batch(
        thetas=thetas, ode_weight=cfg["ode_weight"], ode_inits=ode_inits,
        t_min=cfg["t_min"], t_max=cfg["t_max"], n_steps=cfg["n_steps"],
        prior_pars=cfg["prior_pars"],
        ode_flat=lorenz.lorenz_flat, jac_flat=lorenz.lorenz_jac_flat)
    # lane axis last, covariances packed upper-triangular
    assert mu_b.shape == (cfg["n_steps"] + 1, 3, 3, B)
    assert var_b.shape == (cfg["n_steps"] + 1, 3, 6, B)
    for i in range(B):
        mu_i, var_i = pallas_kalman.solve_mv_fused(
            key=None, interrogate=None, theta=thetas[i],
            ode_flat=lorenz.lorenz_flat, jac_flat=lorenz.lorenz_jac_flat,
            **{**cfg, "ode_init": ode_inits[i]})
        np.testing.assert_allclose(mu_b[..., i], mu_i, rtol=5e-2, atol=5e-2)
        vd = pallas_kalman.unpack_cov(var_b[..., i])
        scale = float(jnp.max(jnp.abs(var_i))) + 1e-30
        np.testing.assert_allclose(vd / scale, var_i / scale, atol=5e-2)


def test_fenrir_fused_batch_matches_single():
    """Lane-batched fenrir == per-lane fenrir_fused."""
    from rodeo_tpu.ops import pallas_fenrir
    cfg = lorenz.setup(n_steps=200, t_max=2.0, dtype=jnp.float32)
    theta = cfg.pop("theta")
    rng = np.random.default_rng(7)
    n_obs = 5
    obs_times = jnp.linspace(0.0, 2.0, n_obs).astype(jnp.float32)
    D = jnp.zeros((n_obs, 3, 1, 3), jnp.float32).at[:, :, :, 0].set(1.0)
    Om = 0.01 * jnp.broadcast_to(jnp.eye(1, dtype=jnp.float32),
                                 (n_obs, 3, 1, 1))
    yobs = jnp.asarray(rng.normal(size=(n_obs, 3, 1)) * 3, jnp.float32)
    B = 3
    thetas = jnp.stack([theta * (1.0 + 0.01 * i) for i in range(B)])
    inits = jnp.broadcast_to(cfg["ode_init"], (B,) + cfg["ode_init"].shape)
    kw = dict(obs_data=yobs, obs_times=obs_times, obs_weight=D, obs_var=Om)
    lls = pallas_fenrir.fenrir_fused_batch(
        thetas=thetas, ode_weight=cfg["ode_weight"], ode_inits=inits,
        t_min=cfg["t_min"], t_max=cfg["t_max"], n_steps=cfg["n_steps"],
        prior_pars=cfg["prior_pars"],
        ode_flat=lorenz.lorenz_flat, jac_flat=lorenz.lorenz_jac_flat, **kw)
    assert lls.shape == (B,)
    for i in range(B):
        ll_i = pallas_fenrir.fenrir_fused(
            key=None, interrogate=None, theta=thetas[i],
            ode_flat=lorenz.lorenz_flat, jac_flat=lorenz.lorenz_jac_flat,
            **kw, **{**cfg, "ode_init": inits[i]})
        np.testing.assert_allclose(float(lls[i]), float(ll_i), rtol=2e-3)


def test_dalton_fused_batch_matches_xla():
    """Lane-batched fused DALTON == XLA dalton (f32)."""
    from rodeo_tpu.ops import pallas_dalton, precond
    cfg = lorenz.setup(n_steps=200, t_max=2.0, dtype=jnp.float32)
    theta = cfg.pop("theta")
    rng = np.random.default_rng(8)
    n_obs = 5
    obs_times = jnp.linspace(0.0, 2.0, n_obs).astype(jnp.float32)
    D = jnp.zeros((n_obs, 3, 1, 3), jnp.float32).at[:, :, :, 0].set(1.0)
    Om = 0.01 * jnp.broadcast_to(jnp.eye(1, dtype=jnp.float32),
                                 (n_obs, 3, 1, 1))
    yobs = jnp.asarray(rng.normal(size=(n_obs, 3, 1)) * 3, jnp.float32)
    B = 3
    thetas = jnp.stack([theta * (1.0 + 0.01 * i) for i in range(B)])
    inits = jnp.broadcast_to(cfg["ode_init"], (B,) + cfg["ode_init"].shape)
    kw = dict(obs_data=yobs, obs_times=obs_times, obs_weight=D, obs_var=Om)
    lls = pallas_dalton.dalton_fused_batch(
        thetas=thetas, ode_weight=cfg["ode_weight"], ode_inits=inits,
        t_min=cfg["t_min"], t_max=cfg["t_max"], n_steps=cfg["n_steps"],
        prior_pars=cfg["prior_pars"],
        ode_flat=lorenz.lorenz_flat, jac_flat=lorenz.lorenz_jac_flat, **kw)
    assert lls.shape == (B,)
    for i in range(B):
        ll_i = precond.dalton(
            key=None, interrogate=interrogate_kramer, theta=thetas[i],
            **kw, **{**cfg, "ode_init": inits[i]})
        # both values are f32 differences of ~1e5-magnitude 200-term sums,
        # so cross-implementation agreement is limited to ~1e-2 relative
        # (f64 parity vs the reference is covered at 1e-7 elsewhere)
        np.testing.assert_allclose(float(lls[i]), float(ll_i), rtol=2e-2)


def test_fused_interrogation_contract(lorenz_cfg):
    """The interrogation argument must be honored, never silently swallowed
    (a chkrebtii caller previously got EK0/EK1 selected by jac_flat)."""
    from rodeo_tpu.interrogate import interrogate_chkrebtii
    from rodeo_tpu.models import fitzhugh

    cfg, theta = lorenz_cfg
    # chkrebtii: runs (eps plumbed through the kernel), finite, and close
    # to the deterministic rodeo solve (the draws perturb the converged
    # posterior only slightly; FitzHugh — on chaotic Lorenz the draws
    # genuinely diverge, as they do in the XLA path too)
    fcfg = fitzhugh.setup(n_steps=100, t_max=5.0, dtype=jnp.float32)
    ftheta = fcfg.pop("theta")
    mu_c, var_c = pallas_kalman.solve_mv_fused(
        key=jax.random.PRNGKey(0), interrogate=interrogate_chkrebtii,
        theta=ftheta, ode_flat=fitzhugh.fitzhugh_flat, jac_flat=None,
        **fcfg)
    assert np.all(np.isfinite(np.asarray(mu_c)))
    mu_r, _ = pallas_kalman.solve_mv_fused(
        key=None, interrogate=interrogate_rodeo, theta=ftheta,
        ode_flat=fitzhugh.fitzhugh_flat, jac_flat=None, **fcfg)
    np.testing.assert_allclose(np.asarray(mu_c[:, :, 0]),
                               np.asarray(mu_r[:, :, 0]),
                               rtol=0.2, atol=0.5)
    # stochastic: a different key must give a different trajectory
    mu_c2, _ = pallas_kalman.solve_mv_fused(
        key=jax.random.PRNGKey(1), interrogate=interrogate_chkrebtii,
        theta=ftheta, ode_flat=fitzhugh.fitzhugh_flat, jac_flat=None,
        **fcfg)
    assert float(np.max(np.abs(np.asarray(mu_c) - np.asarray(mu_c2)))) > 0

    # chkrebtii without a key: clear error
    with pytest.raises(ValueError, match="requires a key"):
        pallas_kalman.solve_mv_fused(
            key=None, interrogate=interrogate_chkrebtii, theta=theta,
            ode_flat=lorenz.lorenz_flat, jac_flat=None, **cfg)

    # an unrecognized custom interrogation: clear error, not a silent
    # algorithm switch
    def custom_interrogate(**kwargs):  # pragma: no cover - never called
        raise AssertionError

    with pytest.raises(ValueError, match="unrecognized"):
        pallas_kalman.solve_mv_fused(
            key=None, interrogate=custom_interrogate, theta=theta,
            ode_flat=lorenz.lorenz_flat, jac_flat=None, **cfg)

    # explicit enum validation
    with pytest.raises(ValueError, match="interrogation must be one of"):
        pallas_kalman.solve_mv_fused(
            key=None, interrogation="bogus", theta=theta,
            ode_flat=lorenz.lorenz_flat, jac_flat=None, **cfg)
    with pytest.raises(ValueError, match="jac_flat"):
        pallas_kalman.solve_mv_fused(
            key=None, interrogation="kramer", theta=theta,
            ode_flat=lorenz.lorenz_flat, jac_flat=None, **cfg)


def test_fused_schober_matches_precond(lorenz_cfg):
    """interrogation='schober' (EK0, zero noise) == the XLA schober path."""
    from rodeo_tpu.interrogate import interrogate_schober

    cfg, theta = lorenz_cfg
    mu_ref, _ = precond.solve_mv(
        key=None, interrogate=interrogate_schober, theta=theta, **cfg)
    mu_f, _ = pallas_kalman.solve_mv_fused(
        key=None, interrogate=interrogate_schober, theta=theta,
        ode_flat=lorenz.lorenz_flat, jac_flat=None, **cfg)
    np.testing.assert_allclose(np.asarray(mu_f[:, :, 0]),
                               np.asarray(mu_ref[:, :, 0]),
                               rtol=2e-3, atol=2e-3)


def test_basic_fused_batch_matches_xla():
    """Lane-batched fused Basic likelihood == XLA basic (f32)."""
    cfg = lorenz.setup(n_steps=200, t_max=2.0, dtype=jnp.float32)
    theta = cfg.pop("theta")
    rng = np.random.default_rng(3)
    n_obs = 5
    obs_times = jnp.linspace(0.0, 2.0, n_obs).astype(jnp.float32)
    yobs = jnp.asarray(rng.normal(size=(n_obs, 3, 1)) * 3, jnp.float32)

    def b_loglik(obs_data, ode_data, **p):
        return jnp.sum(-0.5 * (obs_data[..., 0] - ode_data[..., 0]) ** 2)

    B = 3
    thetas = jnp.stack([theta * (1.0 + 0.01 * i) for i in range(B)])
    inits = jnp.broadcast_to(cfg["ode_init"], (B,) + cfg["ode_init"].shape)
    lls, mean_rows = pallas_kalman.basic_fused_batch(
        thetas=thetas, ode_weight=cfg["ode_weight"], ode_inits=inits,
        t_min=cfg["t_min"], t_max=cfg["t_max"], n_steps=cfg["n_steps"],
        prior_pars=cfg["prior_pars"], obs_data=yobs, obs_times=obs_times,
        obs_loglik=b_loglik, ode_flat=lorenz.lorenz_flat,
        jac_flat=lorenz.lorenz_jac_flat)
    assert lls.shape == (B,)
    for i in range(B):
        ll_i, _ = precond.basic(
            key=None, interrogate=interrogate_kramer, theta=thetas[i],
            obs_data=yobs, obs_times=obs_times, obs_loglik=b_loglik,
            **{**cfg, "ode_init": inits[i]})
        np.testing.assert_allclose(float(lls[i]), float(ll_i), rtol=2e-3,
                                   atol=2e-2)


def test_stationary_matches_exact(lorenz_cfg):
    """The stationary-gain latency path == the exact fused path (the
    Riccati gain is constant to ~4e-7 after ~10 steps on this model, so
    the trajectories agree to f32 accuracy)."""
    cfg, theta = lorenz_cfg
    kw = dict(key=None, interrogate=interrogate_kramer, theta=theta,
              ode_flat=lorenz.lorenz_flat, jac_flat=lorenz.lorenz_jac_flat,
              **cfg)
    mu0, var0 = pallas_kalman.solve_mv_fused(**kw)
    mu1, var1 = pallas_kalman.solve_mv_fused_stationary(n_warm=64, **kw)
    np.testing.assert_allclose(np.asarray(mu1[:, :, 0]),
                               np.asarray(mu0[:, :, 0]),
                               rtol=5e-3, atol=5e-3)
    scale = float(np.abs(np.asarray(var0)).max()) + 1e-30
    np.testing.assert_allclose(np.asarray(var1) / scale,
                               np.asarray(var0) / scale, atol=2e-4)
    # EK0 variant (valid for every model)
    mu0r, _ = pallas_kalman.solve_mv_fused(
        key=None, interrogate=interrogate_rodeo, theta=theta,
        ode_flat=lorenz.lorenz_flat, jac_flat=None, **cfg)
    mu1r, _ = pallas_kalman.solve_mv_fused_stationary(
        key=None, interrogate=interrogate_rodeo, theta=theta,
        ode_flat=lorenz.lorenz_flat, jac_flat=None, n_warm=64, **cfg)
    np.testing.assert_allclose(np.asarray(mu1r[:, :, 0]),
                               np.asarray(mu0r[:, :, 0]),
                               rtol=5e-3, atol=5e-3)


def test_fenrir_fused_batch_grad_matches_jax_grad():
    """Tangent-augmented fused fenrir gradient == jax.grad of the XLA
    path (forward-mode in-kernel jvp; primal must match the fused batch
    exactly)."""
    from rodeo_tpu.ops import pallas_fenrir
    cfg = lorenz.setup(n_steps=100, t_max=1.0, dtype=jnp.float32)
    theta = cfg.pop("theta")
    n_obs = 3
    obs_times = jnp.linspace(0.0, 1.0, n_obs).astype(jnp.float32)
    rng = np.random.default_rng(2)
    yobs = jnp.asarray(rng.normal(size=(n_obs, 3, 1)) * 3, jnp.float32)
    D = jnp.zeros((n_obs, 3, 1, 3), jnp.float32).at[:, :, :, 0].set(1.0)
    Om = 0.01 * jnp.broadcast_to(jnp.eye(1, dtype=jnp.float32),
                                 (n_obs, 3, 1, 1))
    B = 2
    thetas = jnp.stack([theta, theta * 1.01])
    inits = jnp.broadcast_to(cfg["ode_init"], (B,) + cfg["ode_init"].shape)
    kw = dict(obs_data=yobs, obs_times=obs_times, obs_weight=D, obs_var=Om)
    base = dict(ode_weight=cfg["ode_weight"], ode_inits=inits,
                t_min=cfg["t_min"], t_max=cfg["t_max"],
                n_steps=cfg["n_steps"], prior_pars=cfg["prior_pars"],
                ode_flat=lorenz.lorenz_flat,
                jac_flat=lorenz.lorenz_jac_flat)
    ll, grad = pallas_fenrir.fenrir_fused_batch_grad(
        thetas=thetas, **kw, **base)
    ll_ref = pallas_fenrir.fenrir_fused_batch(thetas=thetas, **kw, **base)
    np.testing.assert_array_equal(np.asarray(ll), np.asarray(ll_ref))
    for i in range(B):
        g_ref = jax.grad(lambda th: precond.fenrir(
            key=None, interrogate=interrogate_kramer, theta=th,
            **kw, **cfg))(thetas[i])
        np.testing.assert_allclose(np.asarray(grad[i]), np.asarray(g_ref),
                                   rtol=1e-4, atol=1e-6)


def test_solve_mv_fused_batch_grad_matches_jacfwd():
    """Tangent-augmented fused solve sensitivities d(mean)/d(theta) ==
    jax.jacfwd of the f64 XLA solve; primal means match the fused batch
    exactly."""
    from rodeo_tpu.ops import precond as precond_mod
    cfg = lorenz.setup(n_steps=50, t_max=0.5, dtype=jnp.float32)
    theta = cfg.pop("theta")
    B = 2
    thetas = jnp.stack([theta, theta * 1.02])
    inits = jnp.broadcast_to(cfg["ode_init"], (B,) + cfg["ode_init"].shape)
    base = dict(ode_weight=cfg["ode_weight"], ode_inits=inits,
                t_min=cfg["t_min"], t_max=cfg["t_max"],
                n_steps=cfg["n_steps"], prior_pars=cfg["prior_pars"],
                ode_flat=lorenz.lorenz_flat,
                jac_flat=lorenz.lorenz_jac_flat)
    mean, dmean = pallas_kalman.solve_mv_fused_batch_grad(
        thetas=thetas, **base)
    mean_ref, _ = pallas_kalman.solve_mv_fused_batch(thetas=thetas, **base)
    # the primal path emits smoothing gains in-kernel (emit="gains")
    # while the tangent-augmented variant still computes them in the
    # batched-XLA stage — same math, different fp association, so value
    # parity rather than bit parity
    np.testing.assert_allclose(np.asarray(mean), np.asarray(mean_ref),
                               rtol=5e-3, atol=1e-3)
    # f64 truth for the sensitivities
    cfg64 = lorenz.setup(n_steps=50, t_max=0.5, dtype=jnp.float64)
    cfg64.pop("theta")
    for i in range(B):
        jac = jax.jacfwd(lambda th: precond_mod.solve_mv(
            key=None, interrogate=interrogate_kramer, theta=th,
            **cfg64)[0])(thetas[i].astype(jnp.float64))
        # jac: (n_steps+1, nb, q, n_theta); dmean: (n_theta, ..., B)
        got = np.transpose(np.asarray(dmean[:, :, :, :, i]), (1, 2, 3, 0))
        scale = np.abs(np.asarray(jac)).max() + 1e-12
        np.testing.assert_allclose(got / scale, np.asarray(jac) / scale,
                                   atol=2e-5)


def test_basic_fused_batch_grad_matches_f64():
    """Fused basic value+grad == f64 jax.grad of the XLA basic path."""
    cfg = lorenz.setup(n_steps=50, t_max=0.5, dtype=jnp.float32)
    theta = cfg.pop("theta")
    n_obs = 3
    obs_times = jnp.linspace(0.0, 0.5, n_obs).astype(jnp.float32)
    rng = np.random.default_rng(5)
    yobs = jnp.asarray(rng.normal(size=(n_obs, 3, 1)) * 3, jnp.float32)

    def b_loglik(obs_data, ode_data, **p):
        return jnp.sum(-0.5 * (obs_data[..., 0] - ode_data[..., 0]) ** 2
                       / 0.01)

    B = 2
    thetas = jnp.stack([theta, theta * 1.01])
    inits = jnp.broadcast_to(cfg["ode_init"], (B,) + cfg["ode_init"].shape)
    lls, grads, mean = pallas_kalman.basic_fused_batch_grad(
        thetas=thetas, ode_weight=cfg["ode_weight"], ode_inits=inits,
        t_min=cfg["t_min"], t_max=cfg["t_max"], n_steps=cfg["n_steps"],
        prior_pars=cfg["prior_pars"], obs_data=yobs, obs_times=obs_times,
        obs_loglik=b_loglik, ode_flat=lorenz.lorenz_flat,
        jac_flat=lorenz.lorenz_jac_flat)
    assert lls.shape == (B,) and grads.shape == (B, 3)
    cfg64 = lorenz.setup(n_steps=50, t_max=0.5, dtype=jnp.float64)
    cfg64.pop("theta")
    for i in range(B):
        v_ref, g_ref = jax.value_and_grad(lambda th: precond.basic(
            key=None, interrogate=interrogate_kramer, theta=th,
            obs_data=yobs.astype(jnp.float64),
            obs_times=obs_times.astype(jnp.float64),
            obs_loglik=b_loglik,
            **{**cfg64, "ode_init": inits[i].astype(jnp.float64)})[0])(
                thetas[i].astype(jnp.float64))
        np.testing.assert_allclose(float(lls[i]), float(v_ref), rtol=2e-3,
                                   atol=2e-2)
        np.testing.assert_allclose(np.asarray(grads[i]), np.asarray(g_ref),
                                   rtol=2e-3, atol=1e-2)


def test_dalton_fused_batch_grad_matches_jax_grad():
    """Tangent-augmented fused DALTON gradient == jax.grad of the XLA
    path (in-kernel forward-mode jvp; primal must match the fused batch
    exactly)."""
    from rodeo_tpu.ops import pallas_dalton
    cfg = lorenz.setup(n_steps=100, t_max=1.0, dtype=jnp.float32)
    theta = cfg.pop("theta")
    n_obs = 3
    obs_times = jnp.linspace(0.0, 1.0, n_obs).astype(jnp.float32)
    rng = np.random.default_rng(3)
    yobs = jnp.asarray(rng.normal(size=(n_obs, 3, 1)) * 3, jnp.float32)
    D = jnp.zeros((n_obs, 3, 1, 3), jnp.float32).at[:, :, :, 0].set(1.0)
    Om = 0.01 * jnp.broadcast_to(jnp.eye(1, dtype=jnp.float32),
                                 (n_obs, 3, 1, 1))
    B = 2
    thetas = jnp.stack([theta, theta * 1.01])
    inits = jnp.broadcast_to(cfg["ode_init"], (B,) + cfg["ode_init"].shape)
    kw = dict(obs_data=yobs, obs_times=obs_times, obs_weight=D, obs_var=Om)
    base = dict(ode_weight=cfg["ode_weight"], ode_inits=inits,
                t_min=cfg["t_min"], t_max=cfg["t_max"],
                n_steps=cfg["n_steps"], prior_pars=cfg["prior_pars"],
                ode_flat=lorenz.lorenz_flat,
                jac_flat=lorenz.lorenz_jac_flat)
    ll, grad = pallas_dalton.dalton_fused_batch_grad(
        thetas=thetas, **kw, **base)
    ll_ref = pallas_dalton.dalton_fused_batch(thetas=thetas, **kw, **base)
    np.testing.assert_array_equal(np.asarray(ll), np.asarray(ll_ref))
    # reference gradient in f64: the DALTON gradient is a difference of
    # two ~1e4-magnitude per-filter gradients, and the f32 XLA
    # reverse-mode value is pure cancellation noise at this scale
    # (measured ~50x off); the fused forward-mode f32 gradient tracks the
    # f64 truth to ~1e-5 because the tangent recursion never forms the
    # big intermediate sums
    from rodeo_tpu.inference import dalton as dalton_fn
    cfg64 = lorenz.setup(n_steps=100, t_max=1.0, dtype=jnp.float64)
    cfg64.pop("theta")
    kw64 = dict(obs_data=yobs.astype(jnp.float64),
                obs_times=obs_times.astype(jnp.float64),
                obs_weight=D.astype(jnp.float64),
                obs_var=Om.astype(jnp.float64))
    for i in range(B):
        g_ref = jax.grad(lambda th: dalton_fn(
            key=None, interrogate=interrogate_kramer, theta=th,
            **kw64, **cfg64))(thetas[i].astype(jnp.float64))
        np.testing.assert_allclose(np.asarray(grad[i]), np.asarray(g_ref),
                                   rtol=1e-3, atol=1e-5)
