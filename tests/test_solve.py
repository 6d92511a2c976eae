"""
Solver-level tests:

1. solve_mv against a deliberately naive per-step Python-loop filter/smoother
   (reference strategy #2, cf. `/root/reference/tests/test_rodeofor.py`).
2. Accuracy against scipy.integrate.odeint (reference strategy #4,
   cf. `/root/reference/tests/test_fitz.py`).
3. jit / grad consistency (reference strategy #3,
   cf. `/root/reference/tests/test_rodeojit.py`).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.integrate import odeint

import rodeo_tpu
from rodeo_tpu.kalmantv import standard, square_root, get_backend
from rodeo_tpu.interrogate import (
    interrogate_rodeo, interrogate_schober, interrogate_kramer,
    interrogate_chkrebtii)
from problems import fitz_fun, fitz_odeint, fitz_setup


@pytest.fixture(scope="module")
def fitz():
    return fitz_setup()


def naive_solve_mv(key, setup, interrogate, kalman_type="standard", **params):
    """Plain Python-loop forward filter + backward smoother (no scan)."""
    kf = get_backend(kalman_type)
    W = setup["W"]
    prior_weight, prior_var = setup["prior_pars"]
    n_steps = setup["n_steps"]
    t_min, t_max = setup["t_min"], setup["t_max"]
    n_block, n_bmeas, n_bstate = W.shape
    x_meas = jnp.zeros((n_block, n_bmeas))
    mean_state = jnp.zeros((n_block, n_bstate))

    mu_filt = [setup["x0_block"]]
    var_filt = [jnp.zeros((n_block, n_bstate, n_bstate))]
    mu_pred = [setup["x0_block"]]
    var_pred = [jnp.zeros((n_block, n_bstate, n_bstate))]
    keys = jax.random.split(key, n_steps) if key is not None \
        else [None] * n_steps
    for n in range(n_steps):
        mp, vp = kf.predict(mu_filt[-1], var_filt[-1], mean_state,
                            prior_weight, prior_var)
        wgt_meas, mean_meas, var_meas = interrogate(
            key=keys[n], ode_fun=fitz_fun, ode_weight=W,
            t=t_min + (t_max - t_min) * (n + 1) / n_steps,
            mean_state_pred=mp, var_state_pred=vp, **params)
        mf, vf = kf.update(mp, vp, x_meas, mean_meas, W + wgt_meas, var_meas)
        mu_pred.append(mp)
        var_pred.append(vp)
        mu_filt.append(mf)
        var_filt.append(vf)

    mu_smooth = [mu_filt[n_steps]]
    var_smooth = [var_filt[n_steps]]
    for n in range(n_steps - 1, 0, -1):
        ms, vs = kf.smooth_mv(
            mean_state_next=mu_smooth[0],
            var_state_next=var_smooth[0],
            mean_state_filt=mu_filt[n],
            var_state_filt=var_filt[n],
            mean_state_pred=mu_pred[n + 1],
            var_state_pred=var_pred[n + 1],
            wgt_state=prior_weight,
            var_state=prior_var,
        )
        mu_smooth.insert(0, ms)
        var_smooth.insert(0, vs)
    mu_smooth.insert(0, setup["x0_block"])
    var_smooth.insert(0, jnp.zeros((n_block, n_bstate, n_bstate)))
    return jnp.stack(mu_smooth), jnp.stack(var_smooth)


@pytest.mark.parametrize("interrogate", [
    interrogate_rodeo, interrogate_schober, interrogate_kramer])
def test_solve_mv_vs_naive(fitz, interrogate):
    mu, var = rodeo_tpu.solve_mv(
        key=fitz["key"], ode_fun=fitz_fun, ode_weight=fitz["W"],
        ode_init=fitz["x0_block"], t_min=fitz["t_min"], t_max=fitz["t_max"],
        n_steps=fitz["n_steps"], interrogate=interrogate,
        prior_pars=fitz["prior_pars"], theta=fitz["theta"])
    mu_ref, var_ref = naive_solve_mv(
        fitz["key"], fitz, interrogate, theta=fitz["theta"])
    np.testing.assert_allclose(mu, mu_ref, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(var, var_ref, rtol=1e-8, atol=1e-12)


def test_solve_mv_chkrebtii_vs_naive(fitz):
    """Stochastic interrogation: same key tree must give identical results.

    As in the reference docs (higher_order.md:129), ``kalman_type`` is
    partial-ed into the interrogation."""
    from functools import partial
    chkrebtii = partial(interrogate_chkrebtii, kalman_type="standard")
    mu, var = rodeo_tpu.solve_mv(
        key=fitz["key"], ode_fun=fitz_fun, ode_weight=fitz["W"],
        ode_init=fitz["x0_block"], t_min=fitz["t_min"], t_max=fitz["t_max"],
        n_steps=fitz["n_steps"], interrogate=chkrebtii,
        prior_pars=fitz["prior_pars"], kalman_type="standard",
        theta=fitz["theta"])
    mu_ref, var_ref = naive_solve_mv(
        fitz["key"], fitz, chkrebtii, kalman_type="standard",
        theta=fitz["theta"])
    np.testing.assert_allclose(mu, mu_ref, rtol=1e-9, atol=1e-12)


def test_sqrt_matches_standard(fitz):
    """Square-root and standard filters compute the same posterior."""
    mu_std, var_std = rodeo_tpu.solve_mv(
        key=None, ode_fun=fitz_fun, ode_weight=fitz["W"],
        ode_init=fitz["x0_block"], t_min=fitz["t_min"], t_max=fitz["t_max"],
        n_steps=fitz["n_steps"], interrogate=interrogate_kramer,
        prior_pars=fitz["prior_pars"], kalman_type="standard",
        theta=fitz["theta"])
    prior_weight, prior_var = fitz["prior_pars"]
    prior_pars_sqrt = (prior_weight, jnp.linalg.cholesky(prior_var))
    mu_sqrt, chol_sqrt = rodeo_tpu.solve_mv(
        key=None, ode_fun=fitz_fun, ode_weight=fitz["W"],
        ode_init=fitz["x0_block"], t_min=fitz["t_min"], t_max=fitz["t_max"],
        n_steps=fitz["n_steps"], interrogate=interrogate_kramer,
        prior_pars=prior_pars_sqrt, kalman_type="square-root",
        theta=fitz["theta"])
    np.testing.assert_allclose(mu_sqrt, mu_std, rtol=1e-6, atol=1e-8)
    var_sqrt = chol_sqrt @ jnp.swapaxes(chol_sqrt, -1, -2)
    np.testing.assert_allclose(var_sqrt, var_std, rtol=1e-5, atol=1e-8)


def test_solve_vs_odeint(fitz):
    """Loose accuracy bound against scipy, as in the reference test_fitz."""
    tseq = np.linspace(fitz["t_min"], fitz["t_max"], fitz["n_steps"] + 1)
    exact = odeint(fitz_odeint, np.array([-1.0, 1.0]), tseq,
                   args=(np.array(fitz["theta"]),))
    mu, _ = rodeo_tpu.solve_mv(
        key=fitz["key"], ode_fun=fitz_fun, ode_weight=fitz["W"],
        ode_init=fitz["x0_block"], t_min=fitz["t_min"], t_max=fitz["t_max"],
        n_steps=fitz["n_steps"], interrogate=interrogate_rodeo,
        prior_pars=fitz["prior_pars"], theta=fitz["theta"])
    rel_err = np.max(np.abs(
        (np.asarray(mu[:, :, 0]) - exact) / (0.1 + exact)))
    assert rel_err < 5.0

    xs = rodeo_tpu.solve_sim(
        key=fitz["key"], ode_fun=fitz_fun, ode_weight=fitz["W"],
        ode_init=fitz["x0_block"], t_min=fitz["t_min"], t_max=fitz["t_max"],
        n_steps=fitz["n_steps"], interrogate=interrogate_rodeo,
        prior_pars=fitz["prior_pars"], theta=fitz["theta"])
    rel_err = np.max(np.abs(
        (np.asarray(xs[:, :, 0]) - exact) / (0.1 + exact)))
    assert rel_err < 5.0


def test_jit_grad_consistency(fitz):
    """Jitted vs unjitted values and gradients agree (reference strategy #3)."""

    def obj(theta):
        mu, _ = rodeo_tpu.solve_mv(
            key=fitz["key"], ode_fun=fitz_fun, ode_weight=fitz["W"],
            ode_init=fitz["x0_block"], t_min=fitz["t_min"],
            t_max=fitz["t_max"], n_steps=fitz["n_steps"],
            interrogate=interrogate_rodeo,
            prior_pars=fitz["prior_pars"], theta=theta)
        return jnp.sum(mu ** 2)

    v = obj(fitz["theta"])
    v_jit = jax.jit(obj)(fitz["theta"])
    np.testing.assert_allclose(v, v_jit, rtol=1e-10)
    g = jax.grad(obj)(fitz["theta"])
    g_jit = jax.jit(jax.grad(obj))(fitz["theta"])
    np.testing.assert_allclose(g, g_jit, rtol=1e-8)
    assert jnp.all(jnp.isfinite(g))


def test_solve_sim_shape_and_determinism(fitz):
    xs1 = rodeo_tpu.solve_sim(
        key=fitz["key"], ode_fun=fitz_fun, ode_weight=fitz["W"],
        ode_init=fitz["x0_block"], t_min=fitz["t_min"], t_max=fitz["t_max"],
        n_steps=fitz["n_steps"], interrogate=interrogate_rodeo,
        prior_pars=fitz["prior_pars"], theta=fitz["theta"])
    xs2 = rodeo_tpu.solve_sim(
        key=fitz["key"], ode_fun=fitz_fun, ode_weight=fitz["W"],
        ode_init=fitz["x0_block"], t_min=fitz["t_min"], t_max=fitz["t_max"],
        n_steps=fitz["n_steps"], interrogate=interrogate_rodeo,
        prior_pars=fitz["prior_pars"], theta=fitz["theta"])
    assert xs1.shape == (fitz["n_steps"] + 1, 2, 3)
    np.testing.assert_allclose(xs1, xs2)
    np.testing.assert_allclose(xs1[0], fitz["x0_block"])


def test_solve_sim_eigh_method(fitz):
    """Fast sampling path: same distribution (tight prior => draws hug
    the same posterior mean), jittable."""
    kwargs = dict(
        key=fitz["key"], ode_fun=fitz_fun, ode_weight=fitz["W"],
        ode_init=fitz["x0_block"], t_min=fitz["t_min"], t_max=fitz["t_max"],
        n_steps=fitz["n_steps"], interrogate=interrogate_rodeo,
        prior_pars=fitz["prior_pars"], theta=fitz["theta"])
    xs_svd = rodeo_tpu.solve_sim(method="svd", **kwargs)
    xs_eig = jax.jit(lambda: rodeo_tpu.solve_sim(method="eigh", **kwargs))()
    np.testing.assert_allclose(xs_eig[:, :, 0], xs_svd[:, :, 0],
                               rtol=1e-3, atol=1e-3)


def test_higher_order_q4_and_q5():
    """Second-order ODE solved with q=4 and q=5 priors (higher-order
    states exercise the generic-q kernel paths beyond the common q=3)."""
    def higher_fun(x, t, **params):
        return jnp.array([[jnp.sin(2 * t) - x[0, 0]]])

    def exact_sol(t):
        return (2 * np.sin(t) - 3 * np.cos(t) - np.sin(2 * t)) / 3.0

    from rodeo_tpu.prior import ibm_init
    for n_deriv, x0 in [
        (4, jnp.array([[-1.0, 0.0, 1.0, 2.0]])),
        (5, jnp.array([[-1.0, 0.0, 1.0, 2.0, -1.0]])),
    ]:
        W = jnp.zeros((1, 1, n_deriv)).at[:, :, 2].set(1.0)
        n_steps = 100
        prior = ibm_init(10.0 / n_steps, n_deriv, jnp.array([0.5]))
        mu, _ = rodeo_tpu.solve_mv(
            key=None, ode_fun=higher_fun, ode_weight=W, ode_init=x0,
            t_min=0.0, t_max=10.0, n_steps=n_steps,
            interrogate=interrogate_kramer, prior_pars=prior)
        tseq = np.linspace(0.0, 10.0, n_steps + 1)
        err = np.max(np.abs(np.asarray(mu[:, 0, 0]) - exact_sol(tseq)))
        assert err < 0.05, (n_deriv, err)


def test_solve_sim_eigh_matches_smoother_marginals(fitz):
    """The hoisted eigh sampling path (batched gains + precomputed noise,
    affine-only scan) draws from the exact smoothing posterior: sample
    mean/variance over many draws match solve_mv within MC error."""
    kw = dict(ode_fun=fitz_fun, ode_weight=fitz["W"],
              ode_init=fitz["x0_block"], t_min=fitz["t_min"],
              t_max=fitz["t_max"], n_steps=fitz["n_steps"],
              interrogate=interrogate_kramer,
              prior_pars=fitz["prior_pars"], theta=fitz["theta"])
    mu, var = rodeo_tpu.solve_mv(key=None, **kw)
    n_rep = 600
    keys = jax.random.split(jax.random.PRNGKey(42), n_rep)
    draws = jax.jit(jax.vmap(lambda k: rodeo_tpu.solve_sim(
        key=k, method="eigh", **kw)))(keys)
    est_mean = jnp.mean(draws, axis=0)
    est_var = jnp.var(draws, axis=0)
    sd = jnp.sqrt(jnp.maximum(
        jnp.diagonal(var, axis1=-2, axis2=-1), 1e-30))
    # mean within 5 MC standard errors; pointwise sd within 20%
    z = np.asarray(jnp.abs(est_mean - mu) / (sd / np.sqrt(n_rep) + 1e-12))
    assert z[1:].max() < 5.0, z.max()
    ratio = np.asarray(jnp.sqrt(est_var[1:]) / (sd[1:] + 1e-12))
    assert 0.8 < np.median(ratio) < 1.2, np.median(ratio)


@pytest.mark.parametrize("n_steps", [1, 2, 3])
def test_tiny_n_steps(n_steps):
    """Hoisted smoother/sampler paths handle degenerate horizons (empty
    gain slices at n_steps=1)."""
    from rodeo_tpu.models import fitzhugh
    cfg = fitzhugh.setup(n_steps=n_steps, t_max=0.1 * n_steps,
                         dtype=jnp.float64)
    th = cfg.pop("theta")
    mu, var = rodeo_tpu.solve_mv(
        key=None, interrogate=interrogate_kramer, theta=th, **cfg)
    assert mu.shape[0] == n_steps + 1
    assert not bool(jnp.any(jnp.isnan(mu)))
    for method in ("eigh", "svd"):
        xs = rodeo_tpu.solve_sim(
            key=jax.random.PRNGKey(0), method=method,
            interrogate=interrogate_kramer, theta=th, **cfg)
        assert xs.shape[0] == n_steps + 1
        assert not bool(jnp.any(jnp.isnan(xs)))


def test_solve_sim_eigh_grad_finite():
    """jax.grad through the eigh sampling path must be finite (the stock
    eigh derivative NaNs on the coinciding/zero eigenvalues guaranteed at
    the exact-init end; `ops.linalg.psd_factor_eigh` fixes the JVP)."""
    from rodeo_tpu.models import fitzhugh
    cfg = fitzhugh.setup(n_steps=50, t_max=3.0, dtype=jnp.float64)
    th = cfg.pop("theta")

    def obj(theta):
        xs = rodeo_tpu.solve_sim(
            key=jax.random.PRNGKey(0), method="eigh",
            interrogate=interrogate_kramer, theta=theta, **cfg)
        return jnp.sum(xs[:, :, 0] ** 2)

    v, g = jax.value_and_grad(obj)(th)
    assert bool(jnp.all(jnp.isfinite(g))), g
    # direction agrees with the (finite) svd-path gradient
    def obj_svd(theta):
        xs = rodeo_tpu.solve_sim(
            key=jax.random.PRNGKey(0), method="svd",
            interrogate=interrogate_kramer, theta=theta, **cfg)
        return jnp.sum(xs[:, :, 0] ** 2)

    g_svd = jax.grad(obj_svd)(th)
    cos = jnp.sum(g * g_svd) / (
        jnp.linalg.norm(g) * jnp.linalg.norm(g_svd))
    assert float(cos) > 0.9, (g, g_svd)
