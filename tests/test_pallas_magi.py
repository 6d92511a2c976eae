"""
Fused MAGI (lane-batched, scan driver on CPU) must match the
float64 XLA `precond.magi_logdens` per lane.

The MAGI filter conditions on *exact* pseudo-observations, so the active
state components reset to the data every step and float32 rounding has
nowhere to accumulate — the fused path tracks the f64 value to ~1e-5
relative even over thousands of steps.
"""
import numpy as np
import jax.numpy as jnp

import rodeo_tpu
from rodeo_tpu.ops import precond
from rodeo_tpu.ops.pallas_magi import magi_fused_batch
from rodeo_tpu.interrogate import interrogate_kramer
from rodeo_tpu.models import lorenz

N_STEPS, T_MAX = 200, 2.0


def _path():
    cfg = lorenz.setup(n_steps=N_STEPS, t_max=T_MAX, dtype=jnp.float64)
    theta = cfg.pop("theta")
    mu, _ = rodeo_tpu.solve_mv(
        key=None, interrogate=interrogate_kramer, theta=theta, **cfg)
    return cfg, mu


def ode_expand(u, **p):
    pad = jnp.zeros(u.shape[:-1] + (1,), u.dtype)
    return jnp.concatenate([u, pad], axis=-1)


def test_magi_fused_batch_matches_precond():
    cfg, mu = _path()
    dt = T_MAX / N_STEPS
    B = 4
    rng = np.random.default_rng(7)
    base = mu[:, :, :2]
    # additive roughness separates lanes; the Lorenz demo prior is so
    # diffuse (sigma ~ 5e7) that the logdens is nearly flat in the path,
    # so tighten the process noise for a discriminating test
    subsets = jnp.stack([
        base + 0.2 * i * jnp.asarray(rng.normal(size=base.shape))
        for i in range(B)])
    Qw, Rv = cfg["prior_pars"]
    prior_pars = (Qw, Rv * 1e-5)
    for act in (1, 2):
        lls = magi_fused_batch(
            subsets, ode_expand, act, prior_pars, dt)
        assert lls.shape == (B,)
        refs = np.array([float(precond.magi_logdens(
            ode_data_subset=subsets[i], ode_expand=ode_expand,
            n_active=act, prior_pars=prior_pars, dt=dt))
            for i in range(B)])
        rel = np.max(np.abs((np.asarray(lls) - refs) / refs))
        assert rel < 2e-4, (act, np.asarray(lls), refs)
        # perturbed lanes must actually separate
        assert np.std(refs) > 100.0
        assert np.std(np.asarray(lls)) > 100.0


def test_magi_fused_batch_sig2_lanes():
    """Per-lane process-noise multiplier matches rescaled prior_pars."""
    cfg, mu = _path()
    dt = T_MAX / N_STEPS
    B = 3
    subsets = jnp.broadcast_to(mu[None, :, :, :2],
                               (B,) + mu[:, :, :2].shape)
    sig2 = jnp.array([0.5, 1.0, 2.0])
    lls = magi_fused_batch(
        subsets, ode_expand, 2, cfg["prior_pars"], dt, sig2_lanes=sig2)
    Qw, Rv = cfg["prior_pars"]
    refs = np.array([float(precond.magi_logdens(
        ode_data_subset=subsets[i], ode_expand=ode_expand, n_active=2,
        prior_pars=(Qw, Rv * float(sig2[i])), dt=dt)) for i in range(B)])
    rel = np.max(np.abs((np.asarray(lls) - refs) / refs))
    assert rel < 2e-4, (np.asarray(lls), refs)


def test_magi_fused_batch_grad_matches_jax_grad():
    """Adjoint-kernel path gradient == jax.grad of the f64 XLA density."""
    import jax
    from rodeo_tpu.ops.pallas_magi import magi_fused_batch_grad

    cfg, mu = _path()
    dt = T_MAX / N_STEPS
    B = 3
    rng = np.random.default_rng(3)
    base = mu[:, :, :2]
    subsets = jnp.stack([
        base + 0.1 * (i + 1) * jnp.asarray(rng.normal(size=base.shape))
        for i in range(B)])
    Qw, Rv = cfg["prior_pars"]
    prior_pars = (Qw, Rv * 1e-5)
    for act in (1, 2):
        ld, g = magi_fused_batch_grad(
            subsets, ode_expand, act, prior_pars, dt)
        ld_v = magi_fused_batch(subsets, ode_expand, act, prior_pars, dt)
        assert np.allclose(np.asarray(ld), np.asarray(ld_v), rtol=1e-6)
        assert g.shape == subsets.shape
        for i in range(B):
            g_ref = jax.grad(lambda u: precond.magi_logdens(
                ode_data_subset=u, ode_expand=ode_expand, n_active=act,
                prior_pars=prior_pars, dt=dt))(subsets[i])
            scale = np.max(np.abs(np.asarray(g_ref))) + 1.0
            err = np.max(np.abs(np.asarray(g[i]) - np.asarray(g_ref)))
            assert err / scale < 2e-4, (act, i, err, scale)


def test_magi_fused_batch_grad_theta_lanes():
    """Per-lane theta enters ode_expand; gradient w.r.t. theta returned."""
    import jax
    from rodeo_tpu.ops.pallas_magi import magi_fused_batch_grad

    cfg, mu = _path()
    dt = T_MAX / N_STEPS
    B = 3

    def expand_th(u, theta, **p):
        # theta scales an ACTIVE row (the second derivative) so the
        # theta-gradient flows through every step, not just the seed
        return jnp.concatenate(
            [u[..., :1], theta * u[..., 1:2], jnp.zeros_like(u[..., :1])],
            axis=-1)

    base = mu[:, :, :2]
    subsets = jnp.broadcast_to(base[None], (B,) + base.shape)
    thetas = jnp.array([0.5, 1.0, 1.5])
    Qw, Rv = cfg["prior_pars"]
    prior_pars = (Qw, Rv * 1e-5)
    ld, g_u, g_th = magi_fused_batch_grad(
        subsets, expand_th, 2, prior_pars, dt, theta_lanes=thetas)
    assert g_u.shape == subsets.shape and g_th.shape == thetas.shape
    for i in range(B):
        ref = jax.value_and_grad(lambda th: precond.magi_logdens(
            ode_data_subset=subsets[i], ode_expand=expand_th, n_active=2,
            prior_pars=prior_pars, dt=dt, theta=th))(thetas[i])
        ld_ref, g_ref = float(ref[0]), float(ref[1])
        assert abs(float(ld[i]) - ld_ref) / abs(ld_ref) < 2e-4
        # dL/dtheta = sum gp1 * u1 is a cancelling reduction of the f32
        # path gradient; tolerance scales with the non-cancelled mass
        # |dL/du1 . u1| / theta (exact for this expand), not with |g_ref|
        mass = float(jnp.sum(jnp.abs(
            g_u[i][..., 1] * subsets[i][..., 1]))) / float(thetas[i])
        assert abs(float(g_th[i]) - g_ref) < 1e-2 * (mass + 1.0), (
            i, g_th[i], g_ref, mass)


def test_magi_fused_batch_grad_sig2_lanes():
    """Path gradient stays exact under a per-lane sig2 multiplier."""
    import jax
    from rodeo_tpu.ops.pallas_magi import magi_fused_batch_grad

    cfg, mu = _path()
    dt = T_MAX / N_STEPS
    B = 2
    base = mu[:, :, :2]
    rng = np.random.default_rng(11)
    subsets = jnp.stack([
        base + 0.1 * jnp.asarray(rng.normal(size=base.shape))
        for _ in range(B)])
    sig2 = jnp.array([0.25, 4.0])
    Qw, Rv = cfg["prior_pars"]
    prior_pars = (Qw, Rv * 1e-5)
    ld, g = magi_fused_batch_grad(
        subsets, ode_expand, 2, prior_pars, dt, sig2_lanes=sig2)
    for i in range(B):
        g_ref = jax.grad(lambda u: precond.magi_logdens(
            ode_data_subset=u, ode_expand=ode_expand, n_active=2,
            prior_pars=(Qw, Rv * 1e-5 * float(sig2[i])), dt=dt))(subsets[i])
        scale = np.max(np.abs(np.asarray(g_ref))) + 1.0
        err = np.max(np.abs(np.asarray(g[i]) - np.asarray(g_ref)))
        assert err / scale < 2e-4, (i, err, scale)
