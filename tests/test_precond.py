"""
Taylor-preconditioned solver tests: exact agreement with the plain solver
in f64, and f32 stability on the extreme-conditioning Lorenz prior where
the unpreconditioned covariance filter NaNs.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import rodeo_tpu
from rodeo_tpu.ops import precond
from rodeo_tpu.ops.linalg import fast_linalg, solve_small, inv_small
from rodeo_tpu.interrogate import interrogate_kramer, interrogate_rodeo
from problems import fitz_fun, fitz_setup


def test_solve_small_matches_lu():
    rng = np.random.default_rng(0)
    for n in [1, 2, 3]:
        a = rng.standard_normal((5, n, n))
        a = a @ np.swapaxes(a, -1, -2) + np.eye(n)
        b = rng.standard_normal((5, n, 4))
        v = rng.standard_normal((5, n))
        with fast_linalg():
            x_fast = solve_small(jnp.asarray(a), jnp.asarray(b))
            xv_fast = solve_small(jnp.asarray(a), jnp.asarray(v))
            ainv = inv_small(jnp.asarray(a))
        np.testing.assert_allclose(x_fast, np.linalg.solve(a, b),
                                   rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(
            xv_fast, np.linalg.solve(a, v[..., None])[..., 0],
            rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(ainv, np.linalg.inv(a),
                                   rtol=1e-9, atol=1e-11)
        # outside the context: falls back to LAPACK solve
        x_slow = solve_small(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_allclose(x_slow, np.linalg.solve(a, b), rtol=1e-12)


@pytest.fixture(scope="module")
def fitz():
    return fitz_setup()


@pytest.mark.parametrize("interrogate", [interrogate_kramer,
                                         interrogate_rodeo])
def test_precond_matches_plain_f64(fitz, interrogate):
    kwargs = dict(
        key=None, ode_fun=fitz_fun, ode_weight=fitz["W"],
        ode_init=fitz["x0_block"], t_min=fitz["t_min"], t_max=fitz["t_max"],
        n_steps=fitz["n_steps"], interrogate=interrogate,
        prior_pars=fitz["prior_pars"], theta=fitz["theta"])
    mu, var = rodeo_tpu.solve_mv(**kwargs)
    mu_p, var_p = precond.solve_mv(**kwargs)
    np.testing.assert_allclose(mu_p, mu, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(var_p, var, rtol=1e-6, atol=1e-11)


def test_precond_solve_sim_matches_plain_f64(fitz):
    kwargs = dict(
        key=fitz["key"], ode_fun=fitz_fun, ode_weight=fitz["W"],
        ode_init=fitz["x0_block"], t_min=fitz["t_min"], t_max=fitz["t_max"],
        n_steps=fitz["n_steps"], interrogate=interrogate_rodeo,
        prior_pars=fitz["prior_pars"], theta=fitz["theta"])
    xs = rodeo_tpu.solve_sim(**kwargs)
    xs_p = precond.solve_sim(**kwargs)
    # the SVD draw happens in scaled coordinates, so realizations differ;
    # but with the tight sigma=0.001 prior both draws must hug the same
    # posterior mean path
    np.testing.assert_allclose(xs_p[:, :, 0], xs[:, :, 0],
                               rtol=1e-3, atol=1e-3)


def test_precond_f32_lorenz_stable():
    """Covariance-form f32 on the sigma=5e7 Lorenz prior: the
    preconditioned solver stays finite and tracks the f64 solution (the
    unpreconditioned filter NaNs on the full 10k-step horizon)."""
    from rodeo_tpu.models import lorenz
    cfg32 = lorenz.setup(n_steps=2000, t_max=4.0, dtype=jnp.float32)
    th32 = cfg32.pop("theta")
    mu32, var32 = precond.solve_mv(
        key=None, interrogate=interrogate_kramer, theta=th32, **cfg32)
    assert not bool(jnp.any(jnp.isnan(mu32)))
    assert not bool(jnp.any(jnp.isnan(var32)))

    cfg64 = lorenz.setup(n_steps=2000, t_max=4.0, dtype=jnp.float64)
    th64 = cfg64.pop("theta")
    mu64, _ = rodeo_tpu.solve_mv(
        key=None, interrogate=interrogate_kramer, theta=th64, **cfg64)
    # t_max=4 is pre-chaos-divergence; f32 should track f64 loosely
    err = np.max(np.abs(np.asarray(mu32[:, :, 0]) - np.asarray(mu64[:, :, 0]))
                 / (1.0 + np.abs(np.asarray(mu64[:, :, 0]))))
    assert err < 0.05, err


def test_precond_iterated_f32_lorenz():
    """Parallel-in-time iterated engine in f32 tracks the sequential f64
    solution on a short Lorenz horizon."""
    from rodeo_tpu.models import lorenz
    cfg32 = lorenz.setup(n_steps=2000, t_max=4.0, dtype=jnp.float32)
    th32 = cfg32.pop("theta")
    # NB: n_coarse must resolve the dynamics (Lorenz needs dt <= ~0.02 or
    # the warm-start solve itself diverges); 500 steps over [0,4] = dt 0.008
    mu_it, _ = precond.solve_mv_iterated(
        key=None, interrogate=interrogate_kramer, theta=th32,
        n_iter=20, window_size=250, n_coarse=500, **cfg32)
    assert not bool(jnp.any(jnp.isnan(mu_it)))
    mu_seq, _ = precond.solve_mv(
        key=None, interrogate=interrogate_kramer, theta=th32, **cfg32)
    err = np.max(np.abs(np.asarray(mu_it[:, :, 0]) -
                        np.asarray(mu_seq[:, :, 0]))
                 / (1.0 + np.abs(np.asarray(mu_seq[:, :, 0]))))
    assert err < 0.05, err


def test_precond_fenrir_dalton_match_plain(fitz):
    """Preconditioned fenrir/dalton return the same loglik values (the
    Y-space density is invariant under the state coordinate change)."""
    import importlib
    fen = importlib.import_module("rodeo_tpu.inference.fenrir")
    dal = importlib.import_module("rodeo_tpu.inference.dalton")
    rng = np.random.default_rng(17)
    n_obs = 5
    obs_times = jnp.linspace(fitz["t_min"], fitz["t_max"], n_obs)
    D = jnp.zeros((n_obs, 2, 1, 3)).at[:, :, :, 0].set(1.0)
    Om = 0.01 * jnp.broadcast_to(jnp.eye(1), (n_obs, 2, 1, 1))
    yobs = jnp.asarray(rng.standard_normal((n_obs, 2, 1)))
    kw = dict(
        key=None, ode_fun=fitz_fun, ode_weight=fitz["W"],
        ode_init=fitz["x0_block"], t_min=fitz["t_min"],
        t_max=fitz["t_max"], n_steps=fitz["n_steps"],
        interrogate=interrogate_kramer, prior_pars=fitz["prior_pars"],
        obs_data=yobs, obs_times=obs_times, obs_weight=D, obs_var=Om,
        theta=fitz["theta"])
    np.testing.assert_allclose(
        float(precond.fenrir(**kw)), float(fen.fenrir(**kw)), rtol=1e-8)
    np.testing.assert_allclose(
        float(precond.dalton(**kw)), float(dal.dalton(**kw)), rtol=1e-8)


def _obs_kw(fitz, seed=21, n_obs=5):
    import importlib  # noqa: F401
    rng = np.random.default_rng(seed)
    obs_times = jnp.linspace(fitz["t_min"], fitz["t_max"], n_obs)
    D = jnp.zeros((n_obs, 2, 1, 3)).at[:, :, :, 0].set(1.0)
    Om = 0.01 * jnp.broadcast_to(jnp.eye(1), (n_obs, 2, 1, 1))
    yobs = jnp.asarray(rng.standard_normal((n_obs, 2, 1)))
    solve_kw = dict(
        key=None, ode_fun=fitz_fun, ode_weight=fitz["W"],
        ode_init=fitz["x0_block"], t_min=fitz["t_min"],
        t_max=fitz["t_max"], n_steps=fitz["n_steps"],
        interrogate=interrogate_kramer, prior_pars=fitz["prior_pars"],
        theta=fitz["theta"])
    return solve_kw, dict(obs_data=yobs, obs_times=obs_times,
                          obs_weight=D, obs_var=Om)


def test_fenrir_parallel_backward_matches_sequential(fitz):
    """fenrir with temporal='parallel' (associative-scan backward filter
    over the time-varying conditional chain) == sequential, exactly up to
    fp reordering, in f64."""
    import importlib
    fen = importlib.import_module("rodeo_tpu.inference.fenrir")
    solve_kw, obs_kw = _obs_kw(fitz)
    ll_seq = fen.fenrir(**solve_kw, **obs_kw)
    ll_par = fen.fenrir(temporal="parallel", **solve_kw, **obs_kw)
    np.testing.assert_allclose(float(ll_par), float(ll_seq), rtol=1e-9)
    ll_pp = precond.fenrir(temporal="parallel", **solve_kw, **obs_kw)
    np.testing.assert_allclose(float(ll_pp), float(ll_seq), rtol=1e-8)


def test_precond_solvers_match_plain(fitz):
    """Preconditioned data-conditioned solvers (fenrir/dalton solve_mv,
    dalton solve_sim) return unscaled posteriors matching the plain
    implementations in f64."""
    import importlib
    fen = importlib.import_module("rodeo_tpu.inference.fenrir")
    dal = importlib.import_module("rodeo_tpu.inference.dalton")
    solve_kw, obs_kw = _obs_kw(fitz)
    mu_p, var_p = precond.fenrir_solve_mv(**solve_kw, **obs_kw)
    mu, var = fen.solve_mv(**solve_kw, **obs_kw)
    np.testing.assert_allclose(mu_p, mu, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(var_p, var, rtol=1e-5, atol=1e-10)
    mu_p, var_p = precond.dalton_solve_mv(**solve_kw, **obs_kw)
    mu, var = dal.solve_mv(**solve_kw, **obs_kw)
    np.testing.assert_allclose(mu_p, mu, rtol=1e-7, atol=1e-9)
    # sampling: draws differ (scaled-coordinate noise), but both hug the
    # tight posterior mean path
    kw_key = {**solve_kw, "key": jax.random.PRNGKey(3)}
    xs_p = precond.dalton_solve_sim(**kw_key, **obs_kw)
    np.testing.assert_allclose(xs_p[:, :, 0], mu[:, :, 0],
                               rtol=1e-2, atol=1e-2)


def _nn_obs_loglik(obs_data_i, state, i, **params):
    mean = state[:, 0]
    return jnp.sum(-0.5 * (obs_data_i[:, 0] - mean) ** 2 / 0.01
                   - 0.5 * jnp.log(2 * jnp.pi * 0.01))


def test_precond_daltonng_matches_plain(fitz):
    """The coordinate-change Jacobians of the two state-path densities
    cancel, so preconditioned daltonng equals plain daltonng in f64."""
    import importlib
    dal = importlib.import_module("rodeo_tpu.inference.dalton")
    solve_kw, obs_kw = _obs_kw(fitz)
    kw = dict(obs_data=obs_kw["obs_data"], obs_times=obs_kw["obs_times"],
              obs_loglik_i=_nn_obs_loglik)
    ll_p = precond.daltonng(**solve_kw, **kw)
    ll = dal.daltonng(**solve_kw, **kw)
    np.testing.assert_allclose(float(ll_p), float(ll), rtol=1e-7)
    mu_p, _ = precond.dalton_solve_mv_nn(**solve_kw, **kw)
    mu, _ = dal.solve_mv_nn(**solve_kw, **kw)
    np.testing.assert_allclose(mu_p, mu, rtol=1e-7, atol=1e-9)


def test_precond_basic_matches_plain(fitz):
    import importlib
    bas = importlib.import_module("rodeo_tpu.inference.basic")
    solve_kw, obs_kw = _obs_kw(fitz)

    def obs_loglik(obs_data, ode_data, **params):
        return jnp.sum(-0.5 * (obs_data[..., 0] - ode_data[..., 0]) ** 2)

    kw = dict(obs_data=obs_kw["obs_data"], obs_times=obs_kw["obs_times"],
              obs_loglik=obs_loglik)
    ll_p, xt_p = precond.basic(**solve_kw, **kw)
    ll, xt = bas.basic(**solve_kw, **kw)
    np.testing.assert_allclose(float(ll_p), float(ll), rtol=1e-8)
    np.testing.assert_allclose(xt_p, xt, rtol=1e-7, atol=1e-9)


def test_precond_magi_matches_plain():
    """Scaled-coordinate MAGI + Jacobian correction == plain MAGI (f64)."""
    import importlib
    magi = importlib.import_module("rodeo_tpu.inference.magi")
    from rodeo_tpu.prior import ibm_init
    rng = np.random.default_rng(23)
    n_steps, n_vars, q, dt = 6, 2, 3, 0.5
    U = 0.1 * jnp.cumsum(
        jnp.asarray(rng.standard_normal((n_steps + 1, n_vars, q - 1))),
        axis=0)
    prior_pars = ibm_init(dt, q, jnp.ones(n_vars))

    def ode_expand(u, **params):
        pad = jnp.zeros(u.shape[:-1] + (1,))
        return jnp.concatenate([u, pad], axis=-1)

    ll = magi.magi_logdens(
        ode_data_subset=U, ode_expand=ode_expand, n_active=2,
        prior_pars=prior_pars, kalman_type="standard")
    ll_p = precond.magi_logdens(
        ode_data_subset=U, ode_expand=ode_expand, n_active=2,
        prior_pars=prior_pars, dt=dt, kalman_type="standard")
    np.testing.assert_allclose(float(ll_p), float(ll), rtol=1e-7)


def test_magi_parallel_matches_sequential():
    """magi temporal='parallel' (associative-scan filter + batched
    forecast log-densities) == the sequential scan in f64."""
    import importlib
    magi = importlib.import_module("rodeo_tpu.inference.magi")
    from rodeo_tpu.prior import ibm_init
    rng = np.random.default_rng(31)
    n_steps, n_vars, q, dt = 12, 2, 3, 0.25
    U = 0.1 * jnp.cumsum(
        jnp.asarray(rng.standard_normal((n_steps + 1, n_vars, q - 1))),
        axis=0)
    prior_pars = ibm_init(dt, q, jnp.ones(n_vars))

    def ode_expand(u, **p):
        return jnp.concatenate(
            [u, jnp.zeros(u.shape[:-1] + (1,))], axis=-1)

    kw = dict(ode_data_subset=U, ode_expand=ode_expand, n_active=2,
              prior_pars=prior_pars, kalman_type="standard")
    ll_s = magi.magi_logdens(**kw)
    ll_p = magi.magi_logdens(temporal="parallel", **kw)
    np.testing.assert_allclose(float(ll_p), float(ll_s), rtol=1e-8)


def test_precond_inference_f32_finite():
    """f32 accelerator-path coverage: daltonng / magi / basic stay finite on the
    4k-step Lorenz grid where the unconditioned prior NaNs (VERDICT r1 #4)."""
    from rodeo_tpu.models import lorenz
    from rodeo_tpu.prior import ibm_init
    cfg = lorenz.setup(n_steps=4000, t_max=8.0, dtype=jnp.float32)
    theta = cfg.pop("theta")
    rng = np.random.default_rng(29)
    n_obs = 9
    obs_times = jnp.linspace(0.0, 8.0, n_obs).astype(jnp.float32)
    yobs = jnp.asarray(rng.normal(size=(n_obs, 3, 1)) * 3, jnp.float32)

    ll_ng = precond.daltonng(
        key=None, interrogate=interrogate_kramer, theta=theta,
        obs_data=yobs, obs_times=obs_times,
        obs_loglik_i=_nn_obs_loglik, **cfg)
    assert np.isfinite(float(ll_ng)), "daltonng f32 not finite"

    def obs_loglik(obs_data, ode_data, **params):
        return jnp.sum(-0.5 * (obs_data[..., 0] - ode_data[..., 0]) ** 2)

    ll_b, _ = precond.basic(
        key=None, interrogate=interrogate_kramer, theta=theta,
        obs_data=yobs, obs_times=obs_times, obs_loglik=obs_loglik, **cfg)
    assert np.isfinite(float(ll_b)), "basic f32 not finite"

    # magi on an f32 path sampled from the solver posterior
    mu, _ = precond.solve_mv(
        key=None, interrogate=interrogate_kramer, theta=theta, **cfg)
    dt = 8.0 / 4000

    def ode_expand(u, **params):
        pad = jnp.zeros(u.shape[:-1] + (1,), jnp.float32)
        return jnp.concatenate([u, pad], axis=-1)

    ll_m = precond.magi_logdens(
        ode_data_subset=mu[:, :, :2], ode_expand=ode_expand, n_active=2,
        prior_pars=cfg["prior_pars"], dt=dt, kalman_type="standard")
    assert np.isfinite(float(ll_m)), "magi f32 not finite"


def test_precond_dense_nonblocked_layout():
    """Tiled Taylor scaling (`n_deriv=` kwarg) stabilizes the dense
    `indep_init` layout: the raw dense filter diverges on FitzHugh with
    interrogate_kramer (upstream does too — finite but wrong), while the
    preconditioned dense solve converges to the blocked answer."""
    from rodeo_tpu.prior import indep_init
    s = fitz_setup(n_steps_per_unit=25, t_max=10.0)
    theta = s["theta"]
    dense_prior = indep_init(s["prior_pars"])
    n_block, _, n_deriv = s["W"].shape
    W_dense = jnp.zeros((1, n_block, n_block * n_deriv))
    for b in range(n_block):
        W_dense = W_dense.at[0, b, b * n_deriv:(b + 1) * n_deriv].set(
            s["W"][b, 0])
    x0_dense = s["x0_block"].reshape(1, -1)

    def ode_dense(X, t, **params):
        return fitz_fun(X.reshape(n_block, n_deriv), t, **params)[:, 0][None]

    mu, var = precond.solve_mv(
        key=None, ode_fun=ode_dense, ode_weight=W_dense, ode_init=x0_dense,
        t_min=s["t_min"], t_max=s["t_max"], n_steps=s["n_steps"],
        interrogate=interrogate_kramer, prior_pars=dense_prior,
        n_deriv=n_deriv, theta=theta)
    assert not bool(jnp.any(jnp.isnan(mu)))
    mu_b, _ = precond.solve_mv(
        key=None, ode_fun=fitz_fun, ode_weight=s["W"],
        ode_init=s["x0_block"], t_min=s["t_min"], t_max=s["t_max"],
        n_steps=s["n_steps"], interrogate=interrogate_kramer,
        prior_pars=s["prior_pars"], theta=theta)
    np.testing.assert_allclose(
        np.asarray(mu[:, 0, ::n_deriv]), np.asarray(mu_b[:, :, 0]),
        atol=5e-3)
    # the dense sampler rides the same tiled scaling
    xs = precond.solve_sim(
        key=jax.random.PRNGKey(0), ode_fun=ode_dense, ode_weight=W_dense,
        ode_init=x0_dense, t_min=s["t_min"], t_max=s["t_max"],
        n_steps=s["n_steps"], interrogate=interrogate_kramer,
        prior_pars=dense_prior, n_deriv=n_deriv, method="eigh",
        theta=theta)
    assert not bool(jnp.any(jnp.isnan(xs)))
    np.testing.assert_allclose(
        np.asarray(xs[:, 0, ::n_deriv]), np.asarray(mu[:, 0, ::n_deriv]),
        atol=0.3)


# --- square-root fast path (VERDICT r2 #5) ----------------------------------


def _fitz_obs(fitz, n_obs=11, noise_sd=0.1):
    mu_true, _ = rodeo_tpu.solve_mv(
        key=None, ode_fun=fitz_fun, ode_weight=fitz["W"],
        ode_init=fitz["x0_block"], t_min=fitz["t_min"],
        t_max=fitz["t_max"], n_steps=fitz["n_steps"],
        interrogate=interrogate_kramer, prior_pars=fitz["prior_pars"],
        theta=fitz["theta"])
    obs_times = jnp.linspace(fitz["t_min"], fitz["t_max"], n_obs)
    grid = jnp.linspace(fitz["t_min"], fitz["t_max"], fitz["n_steps"] + 1)
    obs_ind = jnp.searchsorted(grid, obs_times)
    rng = np.random.default_rng(5)
    y = mu_true[obs_ind, :, 0:1] + \
        jnp.asarray(rng.normal(size=(n_obs, 2, 1))) * noise_sd
    D = jnp.zeros((n_obs, 2, 1, 3)).at[:, :, :, 0].set(1.0)
    Om = noise_sd ** 2 * jnp.broadcast_to(jnp.eye(1), (n_obs, 2, 1, 1))
    return dict(obs_data=y, obs_times=obs_times, obs_weight=D, obs_var=Om)


def test_sqrt_fenrir_dense_matches_branched(fitz):
    """The masked-dense sqrt backward (now the default) must equal the
    reference-shaped branched backward bit-for-bit in f64."""
    import importlib
    fenrir_mod = importlib.import_module("rodeo_tpu.inference.fenrir")
    from rodeo_tpu.kalmantv import square_root as sqrt_funs
    obs = _fitz_obs(fitz)
    pw, pv = fitz["prior_pars"]
    prior_sqrt = (pw, jnp.linalg.cholesky(pv))
    obs_sqrt = {**obs, "obs_var": jnp.sqrt(obs["obs_var"])}
    kw = dict(
        key=None, ode_fun=fitz_fun, ode_weight=fitz["W"],
        ode_init=fitz["x0_block"], t_min=fitz["t_min"],
        t_max=fitz["t_max"], n_steps=fitz["n_steps"],
        interrogate=interrogate_kramer, theta=fitz["theta"])
    ll_dense = fenrir_mod.fenrir(
        prior_pars=prior_sqrt, kalman_type="square-root", **obs_sqrt, **kw)
    # branched oracle (reference-shaped path)
    filt_out = fenrir_mod._solve_filter(
        prior_weight=pw, prior_var=prior_sqrt[1],
        kalman_funs=sqrt_funs, **kw)
    ll_branch, _ = fenrir_mod._backward(
        mean_state_filt=filt_out["state_filt"][0],
        var_state_filt=filt_out["state_filt"][1],
        mean_state_pred=filt_out["state_pred"][0],
        var_state_pred=filt_out["state_pred"][1],
        prior_weight=pw, prior_var=prior_sqrt[1],
        t_min=fitz["t_min"], t_max=fitz["t_max"],
        n_steps=fitz["n_steps"], kalman_funs=sqrt_funs, **obs_sqrt)
    np.testing.assert_allclose(float(ll_dense), float(ll_branch),
                               rtol=1e-10)
    # and both must equal the standard-form value
    ll_std = fenrir_mod.fenrir(
        prior_pars=fitz["prior_pars"], kalman_type="standard", **obs, **kw)
    np.testing.assert_allclose(float(ll_dense), float(ll_std), rtol=1e-8)


def test_precond_sqrt_solve_mv_matches_plain(fitz):
    """Preconditioned square-root solve == plain square-root solve (f64);
    the factor-aware prior scaling (scale_prior(sqrt=True)) is load-
    bearing here."""
    pw, pv = fitz["prior_pars"]
    prior_sqrt = (pw, jnp.linalg.cholesky(pv))
    kw = dict(
        key=None, ode_fun=fitz_fun, ode_weight=fitz["W"],
        ode_init=fitz["x0_block"], t_min=fitz["t_min"],
        t_max=fitz["t_max"], n_steps=fitz["n_steps"],
        interrogate=interrogate_kramer, prior_pars=prior_sqrt,
        kalman_type="square-root", theta=fitz["theta"])
    mu, var_f = rodeo_tpu.solve_mv(**kw)
    mu_p, var_f_p = precond.solve_mv(**kw)
    np.testing.assert_allclose(mu_p, mu, rtol=1e-8, atol=1e-10)
    # compare covariances (factors differ by orthogonal rotation)
    cov = var_f @ jnp.swapaxes(var_f, -1, -2)
    cov_p = var_f_p @ jnp.swapaxes(var_f_p, -1, -2)
    np.testing.assert_allclose(cov_p, cov, rtol=1e-6, atol=1e-11)


def test_precond_sqrt_fenrir_matches_plain(fitz):
    """Preconditioned sqrt fenrir == plain sqrt fenrir == standard (f64)."""
    import importlib
    fenrir_mod = importlib.import_module("rodeo_tpu.inference.fenrir")
    obs = _fitz_obs(fitz)
    pw, pv = fitz["prior_pars"]
    prior_sqrt = (pw, jnp.linalg.cholesky(pv))
    obs_sqrt = {**obs, "obs_var": jnp.sqrt(obs["obs_var"])}
    kw = dict(
        key=None, ode_fun=fitz_fun, ode_weight=fitz["W"],
        ode_init=fitz["x0_block"], t_min=fitz["t_min"],
        t_max=fitz["t_max"], n_steps=fitz["n_steps"],
        interrogate=interrogate_kramer, theta=fitz["theta"])
    ll_plain = fenrir_mod.fenrir(
        prior_pars=prior_sqrt, kalman_type="square-root", **obs_sqrt, **kw)
    ll_pre = precond.fenrir(
        prior_pars=prior_sqrt, kalman_type="square-root", **obs_sqrt, **kw)
    np.testing.assert_allclose(float(ll_pre), float(ll_plain), rtol=1e-8)


def test_sym_eigh_small():
    """Closed-form 2x2/3x3 symmetric eigendecomposition == LAPACK on
    random matrices across 12 decades of scale."""
    from rodeo_tpu.ops.linalg import sym_eigh_small
    rng = np.random.default_rng(21)
    for n in (1, 2, 3):
        a = rng.standard_normal((200, n, n))
        a = (a + np.swapaxes(a, -1, -2)) / 2
        a *= 10.0 ** rng.integers(-6, 6, size=(200, 1, 1))
        w, v = sym_eigh_small(jnp.asarray(a))
        w_ref, _ = np.linalg.eigh(a)
        np.testing.assert_allclose(np.asarray(w), w_ref, rtol=1e-8,
                                   atol=1e-10 * np.abs(w_ref).max())
        # reconstruction: V diag(w) V' == A
        rec = np.einsum("bik,bk,bjk->bij", np.asarray(v), np.asarray(w),
                        np.asarray(v))
        sc = np.abs(a).max(axis=(-1, -2), keepdims=True)
        np.testing.assert_allclose(rec / sc, a / sc, atol=1e-7)


def test_sym_eigh_small_degenerate():
    """Repeated/zero eigenvalues: eigenvalues stay exact and the masked
    logpdf use-case (projection onto well-separated eigenspaces) stays
    sound — V diag(w) V' reconstructs A even when the within-subspace
    basis is arbitrary."""
    from rodeo_tpu.ops.linalg import sym_eigh_small
    cases = [
        np.diag([2.0, 2.0, 5.0]),                  # repeated pair
        np.diag([0.0, 0.0, 1.0]),                  # rank-1
        np.eye(3) * 3.0,                           # fully degenerate
        np.diag([1e-12, 1.0, 1.0]),                # near-null + pair
    ]
    rng = np.random.default_rng(3)
    Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    for base in cases:
        a = Q @ base @ Q.T
        w, v = sym_eigh_small(jnp.asarray(a[None]))
        w_ref, _ = np.linalg.eigh(a[None])
        # the trig formula's degenerate-point rounding is ~1e-9 relative
        # to the spectral scale — far below the masked-logpdf threshold
        # (100*eps relative)
        scale = max(np.abs(w_ref).max(), 1e-30)
        np.testing.assert_allclose(np.asarray(w) / scale, w_ref / scale,
                                   atol=1e-7)
        rec = np.einsum("bik,bk,bjk->bij", np.asarray(v), np.asarray(w),
                        np.asarray(v))
        np.testing.assert_allclose(rec, a[None], atol=1e-8)
