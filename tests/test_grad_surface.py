"""
Differentiability sweep: ``jax.value_and_grad`` must be finite across the
whole inference surface, in both plain-f64 and preconditioned forms and
for sequential and parallel-in-time modes.  (The reference's jit/grad
tests cover only the solver entry points, ``tests/test_rodeojit.py``
upstream; likelihood gradients are its flagship use case — MAP/HMC in
``docs/examples/parameter.md`` — but are never tested there.)
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import rodeo_tpu
from rodeo_tpu.models import fitzhugh
from rodeo_tpu.ops import precond
from rodeo_tpu.interrogate import interrogate_kramer
from rodeo_tpu.inference import fenrir, dalton, daltonng, basic


@pytest.fixture(scope="module")
def setup():
    cfg = fitzhugh.setup(n_steps=40, t_max=2.0, dtype=jnp.float64)
    th = cfg.pop("theta")
    n_obs = 5
    obs_times = jnp.linspace(0.0, 2.0, n_obs)
    D = jnp.zeros((n_obs, 2, 1, 3)).at[:, :, :, 0].set(1.0)
    Om = 0.01 * jnp.broadcast_to(jnp.eye(1), (n_obs, 2, 1, 1))
    yobs = jnp.asarray(np.random.default_rng(3).normal(size=(n_obs, 2, 1)))
    obs = dict(obs_data=yobs, obs_times=obs_times, obs_weight=D, obs_var=Om)
    return cfg, th, obs


def _assert_grad_finite(fn, th):
    v, g = jax.value_and_grad(fn)(th)
    assert bool(jnp.isfinite(v)), v
    assert bool(jnp.all(jnp.isfinite(g))), g
    assert float(jnp.linalg.norm(g)) > 0.0


@pytest.mark.parametrize("temporal", ["sequential", "parallel"])
def test_grad_solve_mv(setup, temporal):
    cfg, th, _ = setup
    _assert_grad_finite(lambda t: jnp.sum(rodeo_tpu.solve_mv(
        key=None, interrogate=interrogate_kramer, theta=t,
        temporal=temporal, **cfg)[0]), th)


@pytest.mark.parametrize("fn_name,temporal", [
    ("fenrir", "sequential"), ("fenrir", "parallel"),
    ("dalton", None), ("precond.fenrir", "sequential"),
    ("precond.dalton", None)])
def test_grad_gaussian_likelihoods(setup, fn_name, temporal):
    cfg, th, obs = setup
    fns = {"fenrir": fenrir, "dalton": dalton,
           "precond.fenrir": precond.fenrir,
           "precond.dalton": precond.dalton}
    fn = fns[fn_name]
    kw = dict(key=None, interrogate=interrogate_kramer, **cfg, **obs)
    if temporal is not None:
        kw["temporal"] = temporal
    _assert_grad_finite(lambda t: fn(theta=t, **kw), th)


def test_grad_nongaussian_and_basic(setup):
    cfg, th, obs = setup

    def nn_ll(o, s, i, **p):
        return jnp.sum(-0.5 * (o[:, 0] - s[:, 0]) ** 2 / 0.01)

    for fn in (daltonng, precond.daltonng):
        _assert_grad_finite(lambda t, f=fn: f(
            key=None, interrogate=interrogate_kramer, theta=t,
            obs_data=obs["obs_data"], obs_times=obs["obs_times"],
            obs_loglik_i=nn_ll, **cfg), th)

    def b_ll(obs_data, ode_data, **p):
        return jnp.sum(-0.5 * (obs_data[..., 0] - ode_data[..., 0]) ** 2)

    _assert_grad_finite(lambda t: basic(
        key=None, interrogate=interrogate_kramer, theta=t,
        obs_data=obs["obs_data"], obs_times=obs["obs_times"],
        obs_loglik=b_ll, **cfg)[0], th)


def test_grad_mvn_logpdf_masked():
    """The masked-eigen logpdf's analytic JVP: matches finite differences
    at full rank, and stays finite (where eigh's own JVP NaNs) on
    repeated-eigenvalue and rank-deficient covariances — the shape every
    masked stacked DALTON forecast has."""
    from rodeo_tpu.utils import multivariate_normal_logpdf as lpdf
    rng = np.random.default_rng(0)
    p, eps = 4, 1e-6
    A = rng.normal(size=(p, p))
    C = jnp.asarray(A @ A.T + np.eye(p))
    x = jnp.asarray(rng.normal(size=p))
    mu = jnp.asarray(rng.normal(size=p))
    g = jax.grad(lambda c: lpdf(x, mu, c))(C)
    fd = np.zeros((p, p))
    for i in range(p):
        for j in range(p):
            E = np.zeros((p, p))
            E[i, j] = eps
            fd[i, j] = (float(lpdf(x, mu, C + E))
                        - float(lpdf(x, mu, C - E))) / (2 * eps)
    np.testing.assert_allclose(np.asarray(g), fd, rtol=1e-5, atol=1e-6)
    gx, gm = jax.grad(lpdf, argnums=(0, 1))(x, mu, C)
    np.testing.assert_allclose(np.asarray(gx), -np.asarray(gm), rtol=1e-12)
    # repeated eigenvalues (identity cov): eigh JVP divides by zero gaps
    gi = jax.grad(lambda c: lpdf(x, mu, c))(jnp.eye(p))
    assert bool(jnp.all(jnp.isfinite(gi)))
    np.testing.assert_allclose(
        np.asarray(gi), np.asarray(jax.grad(lambda c: jnp.squeeze(
            -0.5 * ((x - mu) @ jnp.linalg.solve(c, x - mu)
                    + jnp.linalg.slogdet(c)[1])))(jnp.eye(p) * 1.0)),
        rtol=1e-6, atol=1e-8)
    # rank-deficient: gradient lives on the support subspace, finite, and
    # matches a directional finite difference along a support direction
    B = rng.normal(size=(p, 2))
    Cs = jnp.asarray(B @ B.T)
    xs = jnp.asarray((B @ B.T) @ rng.normal(size=p))
    gs = jax.grad(lambda m: lpdf(xs, m, Cs))(jnp.zeros(p))
    assert bool(jnp.all(jnp.isfinite(gs)))
    d = (B @ B.T) @ rng.normal(size=p)
    d = jnp.asarray(d / np.linalg.norm(d))
    fd_dir = (float(lpdf(xs, eps * d, Cs))
              - float(lpdf(xs, -eps * d, Cs))) / (2 * eps)
    np.testing.assert_allclose(float(gs @ d), fd_dir, rtol=1e-5, atol=1e-7)


def test_grad_precond_fenrir_f32(setup):
    """The accelerator-mode (f32, preconditioned) likelihood gradient is
    finite."""
    _, _, obs = setup
    cfg32 = fitzhugh.setup(n_steps=40, t_max=2.0, dtype=jnp.float32)
    th32 = cfg32.pop("theta")
    obs32 = {k: v.astype(jnp.float32) for k, v in obs.items()}
    _assert_grad_finite(lambda t: precond.fenrir(
        key=None, interrogate=interrogate_kramer, theta=t,
        **cfg32, **obs32), th32.astype(jnp.float32))


def test_mvn_logpdf_wide_split_f32():
    """Determinant-significance eigen mask (the DALTON stacked-forecast
    shape): a genuine small direction at a spectral split beyond 1/eps_f32
    must stay live in f32 and match the f64 value; a near-singular 2x2
    whose determinant is below its own rounding noise must stay masked
    (finite, reduced to the dominant direction's marginal)."""
    from rodeo_tpu.utils import multivariate_normal_logpdf as lpdf
    # split ~2e5 (w = {1e3, 2e8}), correlation 0.8 — the measured shape of
    # the stacked DALTON forecast on Lorenz63-4k under Taylor precond
    v00, v11, rho = 2.0e8, 1.18e3, 0.8
    c = rho * np.sqrt(v00 * v11)
    C64 = jnp.asarray([[v00, c], [c, v11]], jnp.float64)
    x64 = jnp.asarray([40.0, -1.7], jnp.float64)
    m64 = jnp.zeros(2, jnp.float64)
    ref = float(lpdf(x64, m64, C64))
    got = float(lpdf(x64.astype(jnp.float32), m64.astype(jnp.float32),
                     C64.astype(jnp.float32)))
    # both eigen-directions live in both dtypes; f32 entry rounding of the
    # ~1e5-condition matrix bounds the achievable agreement
    np.testing.assert_allclose(got, ref, rtol=1e-3)
    # near-singular (rho = 1 up to one rounded entry): det is below its
    # rounding noise, the small direction must be masked -> finite value
    # equal to the dominant direction's 1-D marginal
    c1 = np.float32(np.sqrt(v00 * v11))
    Cs = jnp.asarray([[v00, c1], [c1, v11]], jnp.float32)
    val = float(lpdf(x64.astype(jnp.float32), m64.astype(jnp.float32), Cs))
    assert np.isfinite(val)
    w_hi = v00 + v11  # trace; the masked matrix is rank one
    z_hi = float(x64[0] * np.sqrt(v00 / w_hi) + x64[1] * np.sqrt(v11 / w_hi))
    marg = -0.5 * (z_hi ** 2 / w_hi + np.log(w_hi) + np.log(2 * np.pi))
    np.testing.assert_allclose(val, marg, rtol=1e-4)
