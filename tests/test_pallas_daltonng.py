"""
Fused non-Gaussian DALTON (lane-batched, scan driver on CPU) must
match the float64 XLA `precond.daltonng` on component-independent
observation models.

The comparison target is the f64 XLA value: on the diffuse Lorenz prior
the smoothing-pass covariances are numerically singular, and the fused
path's batched eigen-masked log-densities track the f64 truth to ~1e-3
where the sequential f32 XLA scan drifts by >2x (measured: f64 truth
-130429, fused f32 -130555, XLA f32 -496274 on this config).
"""
import numpy as np
import jax
import jax.numpy as jnp

from rodeo_tpu.ops import precond
from rodeo_tpu.ops.pallas_daltonng import daltonng_fused_batch
from rodeo_tpu.interrogate import interrogate_kramer
from rodeo_tpu.models import lorenz


def _setup():
    cfg = lorenz.setup(n_steps=200, t_max=2.0, dtype=jnp.float32)
    theta = cfg.pop("theta")
    cfg["prior_pars"] = tuple(jnp.asarray(a, jnp.float32)
                              for a in cfg["prior_pars"])
    rng = np.random.default_rng(11)
    n_obs = 5
    obs_times = jnp.linspace(0.0, 2.0, n_obs).astype(jnp.float32)
    yobs = jnp.asarray(rng.normal(size=(n_obs, 3, 1)) * 5, jnp.float32)
    return cfg, theta, obs_times, yobs


def nn_loglik(o, s, i, **p):
    "Reference-style loglik: Gaussian on the 0th derivative per block."
    mean = s[:, 0]
    return jnp.sum(-0.5 * (o[:, 0] - mean) ** 2 / 0.005)


def obs_comp_flat(y_cols, x_col, j, th, iobs):
    "Per-component contribution of nn_loglik (only component 0 observed)."
    del th, iobs, j
    return -0.5 * (y_cols[0] - x_col) ** 2 / 0.005


def test_daltonng_fused_batch_matches_xla():
    cfg, theta, obs_times, yobs = _setup()
    B = 3
    thetas = jnp.stack([theta * (1.0 + 0.01 * i) for i in range(B)])
    inits = jnp.broadcast_to(cfg["ode_init"], (B,) + cfg["ode_init"].shape)
    lls = daltonng_fused_batch(
        thetas=thetas, ode_weight=cfg["ode_weight"], ode_inits=inits,
        t_min=cfg["t_min"], t_max=cfg["t_max"], n_steps=cfg["n_steps"],
        prior_pars=cfg["prior_pars"], obs_data=yobs, obs_times=obs_times,
        obs_comp_flat=obs_comp_flat, obs_dims=(0,),
        ode_flat=lorenz.lorenz_flat, jac_flat=lorenz.lorenz_jac_flat)
    assert lls.shape == (B,)
    assert bool(jnp.all(jnp.isfinite(lls)))
    cfg64 = lorenz.setup(n_steps=200, t_max=2.0, dtype=jnp.float64)
    cfg64.pop("theta")
    for i in range(B):
        ll_i = precond.daltonng(
            key=None, interrogate=interrogate_kramer,
            theta=thetas[i].astype(jnp.float64),
            obs_data=yobs.astype(jnp.float64),
            obs_times=obs_times.astype(jnp.float64),
            obs_loglik_i=nn_loglik, **cfg64)
        np.testing.assert_allclose(float(lls[i]), float(ll_i), rtol=5e-3)


def test_daltonng_fused_poisson():
    """Poisson counts (the reference tutorial's non-Gaussian model) ride
    the fused path and match the XLA daltonng."""
    cfg, theta, obs_times, _ = _setup()
    mu_true, _ = precond.solve_mv(
        key=None, interrogate=interrogate_kramer, theta=theta, **cfg)
    obs_ind = jnp.searchsorted(
        jnp.linspace(0.0, 2.0, cfg["n_steps"] + 1), obs_times)
    b0, b1 = 0.1, 0.05
    lam = jnp.exp(b0 + b1 * mu_true[obs_ind, :, 0])
    yobs = jax.random.poisson(jax.random.PRNGKey(0), lam).astype(
        jnp.float32)[:, :, None]

    def pois_loglik(o, s, i, **p):
        lam_ = jnp.exp(b0 + b1 * s[:, 0])
        return jnp.sum(o[:, 0] * jnp.log(lam_) - lam_)

    def pois_comp_flat(y_cols, x_col, j, th, iobs):
        del th, iobs, j
        loglam = b0 + b1 * x_col
        return y_cols[0] * loglam - jnp.exp(loglam)

    B = 2
    thetas = jnp.stack([theta * (1.0 + 0.01 * i) for i in range(B)])
    inits = jnp.broadcast_to(cfg["ode_init"], (B,) + cfg["ode_init"].shape)
    lls = daltonng_fused_batch(
        thetas=thetas, ode_weight=cfg["ode_weight"], ode_inits=inits,
        t_min=cfg["t_min"], t_max=cfg["t_max"], n_steps=cfg["n_steps"],
        prior_pars=cfg["prior_pars"], obs_data=yobs, obs_times=obs_times,
        obs_comp_flat=pois_comp_flat, obs_dims=(0,),
        ode_flat=lorenz.lorenz_flat, jac_flat=lorenz.lorenz_jac_flat)
    assert bool(jnp.all(jnp.isfinite(lls)))
    cfg64 = lorenz.setup(n_steps=200, t_max=2.0, dtype=jnp.float64)
    cfg64.pop("theta")
    for i in range(B):
        ll_i = precond.daltonng(
            key=None, interrogate=interrogate_kramer,
            theta=thetas[i].astype(jnp.float64),
            obs_data=yobs.astype(jnp.float64),
            obs_times=obs_times.astype(jnp.float64),
            obs_loglik_i=pois_loglik, **cfg64)
        np.testing.assert_allclose(float(lls[i]), float(ll_i), rtol=5e-3)


def test_daltonng_fused_batch_grad():
    """Tangent-augmented fused daltonng gradient: primal == the fused
    batch exactly; gradient matches the f64 XLA `jax.grad` in DIRECTION
    and scale (the value is a ~1e5-magnitude f32 difference of filter
    sums, so componentwise f32 agreement is limited — the check is on
    the normalized gradient and the norm ratio)."""
    cfg, theta, obs_times, yobs = _setup()
    B = 2
    thetas = jnp.stack([theta, theta * 1.01])
    inits = jnp.broadcast_to(cfg["ode_init"], (B,) + cfg["ode_init"].shape)
    from rodeo_tpu.ops.pallas_daltonng import daltonng_fused_batch_grad
    base = dict(ode_weight=cfg["ode_weight"], ode_inits=inits,
                t_min=cfg["t_min"], t_max=cfg["t_max"],
                n_steps=cfg["n_steps"], prior_pars=cfg["prior_pars"],
                obs_data=yobs, obs_times=obs_times,
                obs_comp_flat=obs_comp_flat, obs_dims=(0,),
                ode_flat=lorenz.lorenz_flat,
                jac_flat=lorenz.lorenz_jac_flat)
    ll, grad = daltonng_fused_batch_grad(thetas=thetas, **base)
    ll_ref = daltonng_fused_batch(thetas=thetas, **base)
    # primal emits marginal-filter gains in-kernel (emit="gains"); the
    # tangent variant computes them in the batched-XLA stage — value
    # parity, not bit parity
    np.testing.assert_allclose(np.asarray(ll), np.asarray(ll_ref),
                               rtol=1e-6)
    assert grad.shape == (B, 3)
    cfg64 = lorenz.setup(n_steps=200, t_max=2.0, dtype=jnp.float64)
    cfg64.pop("theta")
    for i in range(B):
        g_ref = jax.grad(lambda th: precond.daltonng(
            key=None, interrogate=interrogate_kramer, theta=th,
            obs_data=yobs.astype(jnp.float64),
            obs_times=obs_times.astype(jnp.float64),
            obs_loglik_i=nn_loglik, **cfg64))(
                thetas[i].astype(jnp.float64))
        g_ref = np.asarray(g_ref)
        g = np.asarray(grad[i])
        assert np.all(np.isfinite(g))
        cos = float(g @ g_ref / (np.linalg.norm(g)
                                 * np.linalg.norm(g_ref)))
        ratio = float(np.linalg.norm(g) / np.linalg.norm(g_ref))
        assert cos > 0.99, (g, g_ref, cos)
        assert 0.9 < ratio < 1.1, (g, g_ref, ratio)
