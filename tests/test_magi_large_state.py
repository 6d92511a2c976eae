"""Large-state MAGI: the blocked filter needs no dense/stationary machinery
(the measurement model is per-block identity, so the Kalman recursion stays
block-diagonal; cross-variable coupling enters only through ``ode_expand``).
These tests pin the d=128 heat fixture (`models/heat.py:magi_setup`) that
the bench's ``large_state_magi`` rows use.

Reference semantics: /root/reference/src/rodeo/inference/magi.py (the
blocked-prior log-density); the large-state fixture itself has no upstream
counterpart.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rodeo_tpu.models import heat
from rodeo_tpu.inference.magi import magi_logdens
from rodeo_tpu.ops import precond


@pytest.fixture(scope="module")
def fixture128():
    return heat.magi_setup(d=128, dtype=jnp.float64)


def test_magi_setup_path_is_ode_consistent(fixture128):
    """The fixture's expanded path must satisfy x'' = kappa L x' exactly
    (closed-form eigenmode), i.e. the appended Taylor coefficient from
    ode_expand equals mu1 * x'."""
    u, ode_expand, _, _ = fixture128
    full = ode_expand(u)
    d = u.shape[1]
    mu1 = -2.0 * (1.0 - np.cos(np.pi / (d + 1))) * float((d + 1) ** 2) \
        * heat.KAPPA
    np.testing.assert_allclose(np.asarray(full[..., 2]),
                               mu1 * np.asarray(u[..., 1]),
                               rtol=1e-9, atol=1e-12)


def test_magi_mle_at_true_kappa(fixture128):
    """With the exact solution path, the kappa-gradient vanishes at the
    true diffusivity and points back toward it from either side."""
    u, ode_expand, pp, _ = fixture128
    g = jax.grad(lambda k: magi_logdens(u, ode_expand, 2, pp, "standard",
                                        kappa=k))
    g_lo, g_at, g_hi = (float(g(k)) for k in
                        (0.9 * heat.KAPPA, heat.KAPPA, 1.1 * heat.KAPPA))
    assert g_lo > 0.0
    assert g_hi < 0.0
    # not exactly zero: the IBM extrapolation of the exact path carries a
    # Taylor-remainder bias, so the MLE sits ~0.5% off the truth
    assert abs(g_at) < 0.01 * abs(g_lo)


def test_magi_perturbed_path_less_likely(fixture128):
    u, ode_expand, pp, _ = fixture128
    ll = float(magi_logdens(u, ode_expand, 2, pp, "standard"))
    rng = np.random.default_rng(0)
    u2 = u + jnp.asarray(rng.normal(size=u.shape) * 1e-4)
    ll2 = float(magi_logdens(u2, ode_expand, 2, pp, "standard"))
    assert ll2 < ll


def test_magi_parallel_matches_sequential(fixture128):
    u, ode_expand, pp, _ = fixture128
    ll_seq = float(magi_logdens(u, ode_expand, 2, pp, "standard",
                                kappa=0.0105))
    ll_par = float(magi_logdens(u, ode_expand, 2, pp, "standard",
                                temporal="parallel", kappa=0.0105))
    np.testing.assert_allclose(ll_par, ll_seq, rtol=1e-10)


def test_magi_precond_matches_plain(fixture128):
    u, ode_expand, pp, dt = fixture128
    ll = float(magi_logdens(u, ode_expand, 2, pp, "standard", kappa=0.0105))
    ll_pre = float(precond.magi_logdens(
        ode_data_subset=u, ode_expand=ode_expand, n_active=2,
        prior_pars=pp, dt=dt, kappa=0.0105))
    np.testing.assert_allclose(ll_pre, ll, rtol=1e-9)


def test_magi_bench_reference_constants(fixture128):
    """Re-derive the cached f64 constants hard-coded in bench.py's
    large_state_magi row so they cannot drift from the fixture."""
    u, ode_expand, pp, _ = fixture128
    v, g = jax.value_and_grad(
        lambda k: magi_logdens(u, ode_expand, 2, pp, "standard",
                               kappa=k))(0.0105)
    np.testing.assert_allclose(float(v), 70321.99094505646, rtol=1e-10)
    np.testing.assert_allclose(float(g), -16376.134603504284, rtol=1e-8)


def test_magi_f32_profile_tracks_f64(fixture128):
    """The float32 preconditioned kappa-profile (what an accelerator runs) must track
    the f64 profile: the relative-likelihood curve over a +-10% kappa range
    errs by <10% of the signal, and the gradient keeps sign and magnitude
    to ~10%."""
    u, ode_expand, pp, dt = fixture128
    f64 = lambda k: float(magi_logdens(u, ode_expand, 2, pp, "standard",
                                       kappa=k))
    u3, oe3, pp3, dt3 = heat.magi_setup(d=128, dtype=jnp.float32)
    # jitted, as production runs it: XLA's fused arithmetic rounds ~5x
    # tighter than the op-by-op eager path here
    f32j = jax.jit(lambda k: precond.magi_logdens(
        ode_data_subset=u3, ode_expand=oe3, n_active=2, prior_pars=pp3,
        dt=dt3, kappa=k))
    f32 = lambda k: float(f32j(jnp.float32(k)))
    ks = [0.009, 0.0095, 0.01, 0.0105, 0.011]
    c64 = np.array([f64(k) for k in ks])
    c32 = np.array([f32(k) for k in ks])
    d64 = c64 - c64[2]
    d32 = c32 - c32[2]
    signal = np.max(np.abs(d64))
    assert signal > 5.0  # the fixture is kappa-informative
    assert np.max(np.abs(d64 - d32)) < 0.1 * signal
    g64 = float(jax.grad(lambda k: magi_logdens(
        u, ode_expand, 2, pp, "standard", kappa=k))(0.0105))
    g32 = float(jax.grad(lambda k: precond.magi_logdens(
        ode_data_subset=u3, ode_expand=oe3, n_active=2, prior_pars=pp3,
        dt=dt3, kappa=k))(jnp.float32(0.0105)))
    assert abs(g32 - g64) / abs(g64) < 0.15


def test_magi_d1024_reference_constants():
    """d=1024 (state dim 3072): same checks at the bench's largest size."""
    u, ode_expand, pp, _ = heat.magi_setup(d=1024, dtype=jnp.float64)
    v, g = jax.value_and_grad(
        lambda k: magi_logdens(u, ode_expand, 2, pp, "standard",
                               kappa=k))(0.0105)
    np.testing.assert_allclose(float(v), 562576.148847129, rtol=1e-10)
    np.testing.assert_allclose(float(g), -130145.82732490015, rtol=1e-8)
