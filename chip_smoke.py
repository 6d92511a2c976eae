#!/usr/bin/env python3
"""On-card smoke test: rodeo_tpu's main path on an NVIDIA GPU.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py               # phases 0-5 on one card
    python chip_smoke.py --four-cards  # the three cross-card paths on four
                                       # cards, each against one card

Phases (each prints one line; any failure exits non-zero):

0. device: a GPU is required — no CPU fallback;
1. XLA main path: ``precond.solve_mv`` on Lorenz63 (10k steps, f32)
   against the f64 reference, and the README quick-start solve;
2. the lane-batched fused solve at 2048 lanes and the one-lane
   ``solve_mv_fused``, against the reference; on the Triton route also
   kernel against scan driver on the card;
3. fused fenrir likelihood + gradient against the f64 reference on the
   chaotic Lorenz63 fixture and on FitzHugh-Nagumo, where f32 gradients
   are sound, then a few lockstep MALA steps on the Lorenz63 gradient;
4. the large-state heat equation (d=128, state 384) against its closed
   form;
5. the card-only checks of the test suite (``@pytest.mark.gpu``).

Accuracy rules (the bench's): on the chaotic Lorenz63 system a pointwise
f32-vs-f64 comparison is meaningful only over the t <= 4 prefix, and
f32 rounding is amplified on any hardware, so a solve passes when its
max abs error there is <= max(3 x the f32-on-CPU control, 0.05); a
likelihood value or gradient passes at <= 3 x its f32-on-CPU control.
On the chaotic fixture that control is poor (the f32 gradient is off by
more than its norm on any hardware), so the FitzHugh gradient row, whose
f32 control is ~1e-6, is the one that would catch a wrong gradient.

The last line of stdout is one JSON object with ``ok`` and the device as
JAX reports it.  One JAX process uses the card; the only child process
is ``nvidia-smi``.
"""
import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

N_STEPS = 10000
T_MAX = 20.0
N_LANES = 2048


class PhaseFailed(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise PhaseFailed(what)


def card_line():
    """``name, power.limit`` of every card, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().replace("\n", " | ")


def max_err_prefix(mu, mu_ref, n_prefix):
    """Max abs error of the 0th derivative over the first ``n_prefix``
    grid rows."""
    import numpy as np
    a = np.asarray(mu)[:n_prefix, :, 0]
    b = np.asarray(mu_ref)[:n_prefix, :, 0]
    return float(np.max(np.abs(a - b)))


def phase(name, fn):
    t0 = time.perf_counter()
    info = fn()
    dt = time.perf_counter() - t0
    print(f"phase {name}: ok ({dt:.1f} s) {json.dumps(info)}", flush=True)


def load_refs():
    import numpy as np
    with np.load(os.path.join(REPO, ".bench_ref_v8.npz")) as z:
        truth = {k: z[k] for k in z.files}
    with np.load(os.path.join(REPO, ".bench_ref_v8_ctrl.npz")) as z:
        truth.update({k: z[k] for k in z.files})
    return truth


def lorenz_cfg(n_steps):
    import jax.numpy as jnp
    from rodeo_tpu.models import lorenz
    cfg = lorenz.setup(n_steps=n_steps, t_max=T_MAX, dtype=jnp.float32)
    theta = cfg.pop("theta")
    return cfg, theta


def phase_xla(truth, tol_solve):
    import jax
    import jax.numpy as jnp
    import rodeo_tpu
    from rodeo_tpu.interrogate import interrogate_kramer, interrogate_rodeo
    from rodeo_tpu.models import fitzhugh
    from rodeo_tpu.ops import precond

    cfg, theta = lorenz_cfg(N_STEPS)
    solve = jax.jit(lambda th: precond.solve_mv(
        key=None, interrogate=interrogate_kramer, theta=th, **cfg)[0])
    mu = jax.block_until_ready(solve(theta))
    err = max_err_prefix(mu, truth["solve_mu_10k"], N_STEPS // 5)
    check(bool(jnp.all(jnp.isfinite(mu))), "precond.solve_mv not finite")
    check(err <= tol_solve,
          f"precond.solve_mv t<=4 error {err} > {tol_solve}")
    # README quick start (FitzHugh-Nagumo, f64 config as published)
    fcfg = fitzhugh.setup(dtype=jnp.float32)
    fth = fcfg.pop("theta")
    mu_f, var_f = rodeo_tpu.solve_mv(
        key=None, interrogate=interrogate_rodeo, theta=fth, **fcfg)
    check(bool(jnp.all(jnp.isfinite(mu_f)) and jnp.all(jnp.isfinite(var_f))),
          "README quick-start solve_mv not finite")
    return {"precond_solve_mv_t4_max_abs_err": err,
            "tolerance": tol_solve,
            "quickstart_final_state": [float(v) for v in mu_f[-1, :, 0]]}


def phase_fused(truth, tol_solve, ctrl):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from rodeo_tpu.models import lorenz
    from rodeo_tpu.ops import pallas_kalman
    from rodeo_tpu.ops.scan import fused_route, kernel_route

    cfg, theta = lorenz_cfg(N_STEPS)
    # distinct lanes (lane 0 is the reference parameter), so a kernel that
    # mixed lanes up would show in the kernel-vs-scan comparison
    thetas = theta * (1 + 1e-6 * jnp.arange(N_LANES, dtype=jnp.float32)
                      [:, None])
    inits = jnp.broadcast_to(cfg["ode_init"],
                             (N_LANES,) + cfg["ode_init"].shape)

    def batch(ts, x0):
        return pallas_kalman.solve_mv_fused_batch(
            thetas=ts, ode_weight=cfg["ode_weight"], ode_inits=x0,
            t_min=cfg["t_min"], t_max=cfg["t_max"], n_steps=N_STEPS,
            prior_pars=cfg["prior_pars"], ode_flat=lorenz.lorenz_flat,
            jac_flat=lorenz.lorenz_jac_flat)

    route = kernel_route()
    mean, var = jax.block_until_ready(jax.jit(batch)(thetas, inits))
    check(mean.shape == (N_STEPS + 1, 3, 3, N_LANES), "batch mean shape")
    check(bool(jnp.all(jnp.isfinite(mean)) and jnp.all(jnp.isfinite(var))),
          "solve_mv_fused_batch not finite")
    err_b = max_err_prefix(mean[..., 0], truth["solve_mu_10k"],
                           N_STEPS // 5)
    check(err_b <= tol_solve,
          f"solve_mv_fused_batch lane 0 t<=4 error {err_b} > {tol_solve}")

    one = jax.jit(lambda th: pallas_kalman.solve_mv_fused(
        key=None, interrogate=None, theta=th,
        ode_flat=lorenz.lorenz_flat, jac_flat=lorenz.lorenz_jac_flat,
        **cfg))
    mu1, var1 = jax.block_until_ready(one(theta))
    err_1 = max_err_prefix(mu1, truth["solve_mu_10k"], N_STEPS // 5)
    check(bool(jnp.all(jnp.isfinite(mu1))), "solve_mv_fused not finite")
    check(err_1 <= tol_solve,
          f"solve_mv_fused t<=4 error {err_1} > {tol_solve}")
    info = {"route": route, "lanes": N_LANES,
            "batch_lane0_t4_max_abs_err": err_b,
            "one_lane_t4_max_abs_err": err_1, "tolerance": tol_solve}
    if route == "triton":
        # kernel against the scan driver of the same step functions, on
        # every one of the first 128 lanes: the two sum in different orders
        # and Triton contracts FMAs, so they may differ by f32 rounding as
        # the chaotic system amplifies it — at most the f32-on-CPU
        # control's own error against f64
        n_cmp = 128
        with fused_route("scan"):
            mean_s, _ = jax.block_until_ready(jax.jit(batch)(
                thetas[:n_cmp], inits[:n_cmp]))
        n_pre = N_STEPS // 5
        diff = float(np.max(np.abs(
            np.asarray(mean[:n_pre, :, 0, :n_cmp])
            - np.asarray(mean_s[:n_pre, :, 0, :]))))
        check(diff <= ctrl,
              f"Triton kernel vs scan driver t<=4 diff over {n_cmp} lanes "
              f"{diff} > {ctrl}")
        info["kernel_vs_scan_t4_max_abs_diff_128_lanes"] = diff
        info["kernel_vs_scan_tolerance"] = ctrl
    return info


# FitzHugh-Nagumo fenrir fixture (the model's own setup: 250 steps,
# t_max=10): 11 observations of both components from the f64 solve plus
# N(0, 0.1) noise, gradients at two parameters off the truth
FHN_OBS = 11
FHN_VAR = 0.1
FHN_SCALES = (1.1, 0.9)
# two f32 implementations of one gradient round differently; against f64
# they may differ by a small factor, a wrong gradient by ~1e6 x the control
FHN_TOL_FACTOR = 100.0


def fhn_fixture(dtype, yobs):
    import jax.numpy as jnp
    from rodeo_tpu.models import fitzhugh
    cfg = fitzhugh.setup(dtype=dtype)
    theta = cfg.pop("theta")
    n_block, _, q = cfg["ode_weight"].shape
    obs = dict(
        obs_data=jnp.asarray(yobs, dtype),
        obs_times=jnp.linspace(cfg["t_min"], cfg["t_max"],
                               FHN_OBS).astype(dtype),
        obs_weight=jnp.zeros((FHN_OBS, n_block, 1, q),
                             dtype).at[..., 0].set(1.0),
        obs_var=FHN_VAR * jnp.ones((FHN_OBS, n_block, 1, 1), dtype))
    return cfg, theta, obs


def fhn_cpu_reference():
    """The fixture's data, then the value and gradient of the XLA
    ``precond.fenrir`` at each parameter: the f64 reference and the
    f32 control, both on the CPU."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from rodeo_tpu.interrogate import interrogate_kramer
    from rodeo_tpu.ops import precond

    def value_grads(dtype, yobs):
        cfg, theta, obs = fhn_fixture(dtype, yobs)
        vg = jax.jit(jax.value_and_grad(lambda th: precond.fenrir(
            key=None, interrogate=interrogate_kramer, theta=th, **obs,
            **cfg)))
        out = [vg(theta * s) for s in FHN_SCALES]
        return (np.array([float(v) for v, _ in out]),
                np.stack([np.asarray(g, np.float64) for _, g in out]))

    with jax.default_device(jax.devices("cpu")[0]):
        with jax.enable_x64(True):
            cfg, theta, _ = fhn_fixture(jnp.float64, np.zeros((1, 1, 1)))
            mu, _ = precond.solve_mv(key=None, interrogate=interrogate_kramer,
                                     theta=theta, **cfg)
            stride = cfg["n_steps"] // (FHN_OBS - 1)
            clean = np.asarray(mu[::stride, :, :1])
            yobs = clean + np.sqrt(FHN_VAR) * np.random.default_rng(
                0).normal(size=clean.shape)
            ref = value_grads(jnp.float64, yobs)
        ctrl = value_grads(jnp.float32, yobs)
    return yobs, ref, ctrl


def phase_fhn_gradient():
    """Fused fenrir value and gradient on the card, per lane, against the
    f64 reference, limited by the f32-on-CPU control's own error."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from rodeo_tpu.models import fitzhugh
    from rodeo_tpu.ops import pallas_fenrir

    yobs, (ll64, g64), (ll32, g32) = fhn_cpu_reference()
    cfg, theta, obs = fhn_fixture(jnp.float32, yobs)
    thetas = jnp.stack([theta * s for s in FHN_SCALES])
    inits = jnp.broadcast_to(cfg["ode_init"],
                             (len(FHN_SCALES),) + cfg["ode_init"].shape)
    ll, grad = jax.block_until_ready(jax.jit(
        lambda ts: pallas_fenrir.fenrir_fused_batch_grad(
            thetas=ts, ode_weight=cfg["ode_weight"], ode_inits=inits,
            t_min=cfg["t_min"], t_max=cfg["t_max"], n_steps=cfg["n_steps"],
            prior_pars=cfg["prior_pars"], ode_flat=fitzhugh.fitzhugh_flat,
            jac_flat=fitzhugh.fitzhugh_jac_flat, **obs))(thetas))
    grad = np.asarray(grad, np.float64)
    norm = np.linalg.norm(g64, axis=1)
    rel_g = np.linalg.norm(grad - g64, axis=1) / norm
    ctrl_g = np.linalg.norm(g32 - g64, axis=1) / norm
    err_ll = np.abs(np.asarray(ll, np.float64) - ll64)
    ctrl_ll = np.abs(ll32 - ll64)
    for i in range(len(FHN_SCALES)):
        check(rel_g[i] <= FHN_TOL_FACTOR * ctrl_g[i],
              f"FitzHugh fenrir grad lane {i} rel err {rel_g[i]} > "
              f"{FHN_TOL_FACTOR} x control {ctrl_g[i]}")
        check(err_ll[i] <= FHN_TOL_FACTOR * ctrl_ll[i],
              f"FitzHugh fenrir ll lane {i} abs err {err_ll[i]} > "
              f"{FHN_TOL_FACTOR} x control {ctrl_ll[i]}")
    return {"fhn_fenrir_grad_rel_err": rel_g.tolist(),
            "fhn_fenrir_grad_control": ctrl_g.tolist(),
            "fhn_fenrir_ll_abs_err": err_ll.tolist(),
            "fhn_fenrir_ll_control": ctrl_ll.tolist(),
            "tolerance_factor": FHN_TOL_FACTOR}


def phase_likelihood(truth):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from rodeo_tpu.models import lorenz
    from rodeo_tpu.ops import pallas_fenrir
    from rodeo_tpu.parallel.chains import make_mala_runner

    # the bench's fenrir fixture: Lorenz63, 4k steps, 21 noisy obs rng(0)
    cfg, theta = lorenz_cfg(4000)
    n_obs = 21
    obs_times = jnp.linspace(0.0, T_MAX, n_obs).astype(jnp.float32)
    D = jnp.zeros((n_obs, 3, 1, 3), jnp.float32).at[:, :, :, 0].set(1.0)
    Om = 0.005 * jnp.broadcast_to(jnp.eye(1, dtype=jnp.float32),
                                  (n_obs, 3, 1, 1))
    yobs = jnp.asarray(
        np.random.default_rng(0).normal(size=(n_obs, 3, 1)) * 5,
        jnp.float32)
    n_chains = 128
    inits = jnp.broadcast_to(cfg["ode_init"],
                             (n_chains,) + cfg["ode_init"].shape)

    def logpost_grad(positions):
        return pallas_fenrir.fenrir_fused_batch_grad(
            thetas=positions, ode_weight=cfg["ode_weight"],
            ode_inits=inits, t_min=cfg["t_min"], t_max=cfg["t_max"],
            n_steps=cfg["n_steps"], prior_pars=cfg["prior_pars"],
            obs_data=yobs, obs_times=obs_times, obs_weight=D, obs_var=Om,
            ode_flat=lorenz.lorenz_flat, jac_flat=lorenz.lorenz_jac_flat)

    pos0 = jnp.broadcast_to(theta, (n_chains, 3))
    ll, grad = jax.block_until_ready(jax.jit(logpost_grad)(pos0))
    check(bool(jnp.all(jnp.isfinite(ll)) and jnp.all(jnp.isfinite(grad))),
          "fenrir_fused_batch_grad not finite")
    ref_ll = float(truth["fenrir_ll"])
    err_ll = abs(float(ll[0]) - ref_ll)
    ctrl_ll = abs(float(truth["fenrir_ll_f32cpu"]) - ref_ll)
    g64 = np.asarray(truth["fenrir_grad"], np.float64)
    rel_g = float(np.linalg.norm(np.asarray(grad[0], np.float64) - g64)
                  / np.linalg.norm(g64))
    ctrl_g = float(np.linalg.norm(
        np.asarray(truth["fenrir_grad_f32cpu"], np.float64) - g64)
        / np.linalg.norm(g64))
    check(err_ll <= 3.0 * ctrl_ll,
          f"fenrir ll abs err {err_ll} > 3 x control {ctrl_ll}")
    check(rel_g <= 3.0 * ctrl_g,
          f"fenrir grad rel err {rel_g} > 3 x control {ctrl_g}")
    # lockstep MALA on the same value+gradient (the posterior is very
    # sharp: the step size gives acceptance strictly inside (0, 1))
    runner = make_mala_runner(logpost_grad, n_chains, 10, 1e-7)
    positions, ld, accept = jax.block_until_ready(
        runner(pos0, jax.random.PRNGKey(0)))
    mean_acc = float(jnp.mean(accept))
    check(bool(jnp.all(jnp.isfinite(positions)) and
               jnp.all(jnp.isfinite(ld))), "MALA states not finite")
    check(0.0 < mean_acc < 1.0, f"MALA acceptance {mean_acc} not in (0, 1)")
    return {"fenrir_ll_abs_err": err_ll, "fenrir_ll_control": ctrl_ll,
            "fenrir_grad_rel_err": rel_g, "fenrir_grad_control": ctrl_g,
            "mala_chains": n_chains, "mala_mean_accept": mean_acc,
            **phase_fhn_gradient()}


def phase_large_state():
    import jax
    import jax.numpy as jnp
    from rodeo_tpu.interrogate import interrogate_kramer
    from rodeo_tpu.models import heat
    from rodeo_tpu.ops import precond
    from rodeo_tpu.ops.stationary import solve_mv_stationary

    cfg = heat.setup(d=128, n_deriv=3, n_steps=1000, dtype=jnp.float32)
    exact = jnp.asarray(cfg.pop("exact")(cfg["t_max"]), jnp.float32)
    p = cfg.pop("n_deriv")
    out = {}
    for name, fn in (
            ("exact_dense", lambda: precond.solve_mv(
                key=None, interrogate=interrogate_kramer, n_deriv=p,
                **cfg)),
            ("stationary", lambda: solve_mv_stationary(
                key=None, interrogate=interrogate_kramer, n_deriv=p,
                n_warm=32, **cfg))):
        mu, _ = jax.block_until_ready(jax.jit(fn)())
        err = float(jnp.max(jnp.abs(mu[-1, 0, ::p] - exact)))
        check(err <= 1e-4, f"heat d=128 {name} error {err} > 1e-4")
        out[f"{name}_max_abs_err"] = err
    return out


def phase_gpu_tests():
    """Run the suite's ``@pytest.mark.gpu`` checks here: the test
    configuration pins the CPU, so pytest cannot run them on the card."""
    import importlib
    import inspect
    sys.path.insert(0, os.path.join(REPO, "tests"))
    ran = []
    for mod_name in ("test_triton_kalman",):
        mod = importlib.import_module(mod_name)
        for name, fn in inspect.getmembers(mod, inspect.isfunction):
            marks = [m.name for m in getattr(fn, "pytestmark", [])]
            if name.startswith("test_") and "gpu" in marks:
                fn(on_gpu=None)
                ran.append(f"{mod_name}::{name}")
    check(ran, "no card-only tests found")
    return {"ran": ran}


def four_card_paths():
    """The three cross-card paths on four cards, each against the same
    computation on one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import rodeo_tpu
    from rodeo_tpu.interrogate import interrogate_kramer, interrogate_rodeo
    from rodeo_tpu.inference import pseudo_marginal as pm
    from rodeo_tpu.models import fitzhugh, heat
    from rodeo_tpu.models.fitzhugh import fitzhugh_flat, fitzhugh_jac_flat
    from rodeo_tpu.parallel import (
        make_mesh, run_chains, run_chains_fused, run_chains_fused_sharded,
        sharded_solve_mv_iterated)
    from rodeo_tpu.parallel.large_state import sharded_solve_mv_stationary
    from rodeo_tpu.ops.ptime import solve_mv_iterated
    from rodeo_tpu.ops.stationary import solve_mv_stationary

    n_dev = len(jax.devices())
    check(n_dev == 4, f"--four-cards needs 4 devices, found {n_dev}")
    one = jax.devices()[:1]
    results = {}

    def host_diff(a, b):
        return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))

    def on_each_device(arr):
        return [int(s.device.id) for s in arr.addressable_shards]

    # 1. chains over a chain mesh (vmapped pseudo-marginal MCMC, and the
    #    lockstep fused sampler with lane groups per card)
    cfg = fitzhugh.setup(n_steps=200, t_max=10.0, dtype=jnp.float32)
    theta = cfg.pop("theta")
    mu_ref, _ = rodeo_tpu.solve_mv(
        key=None, interrogate=interrogate_rodeo, theta=theta, **cfg)

    def logpost(th, key):
        xs = rodeo_tpu.solve_sim(key=key, interrogate=interrogate_rodeo,
                                 theta=th, method="eigh", **cfg)
        return -0.5 * jnp.sum((xs[:, :, 0] - mu_ref[:, :, 0]) ** 2) / 0.01, \
            xs

    alg = pm.normal_random_walk(logpost, 0.02 * jnp.ones(3, jnp.float32))
    n_chains = 64
    init = jnp.broadcast_to(theta, (n_chains, 3)).astype(jnp.float32)
    mesh4 = make_mesh(n_devices=4, axis_name="chain")
    mesh1 = jax.sharding.Mesh(np.array(one), ("chain",))
    pos4, st4, _ = run_chains(alg, init, jax.random.PRNGKey(1),
                              n_samples=4, mesh=mesh4, axis_name="chain")
    pos1, st1, _ = run_chains(alg, init, jax.random.PRNGKey(1),
                              n_samples=4, mesh=mesh1, axis_name="chain")
    check(sorted(set(on_each_device(st4.logdensity))) == [0, 1, 2, 3],
          "run_chains did not spread over the four cards")
    d_rc = host_diff(pos4, pos1)
    check(bool(jnp.all(jnp.isfinite(st4.logdensity))), "run_chains finite")
    check(d_rc <= 1e-3, f"run_chains 4 vs 1 card positions differ {d_rc}")
    results["run_chains_max_abs_diff"] = d_rc

    def loglik(positions, paths):
        resid = paths[:, :, 0, :] - mu_ref[:, :, 0, None]
        return -0.5 * jnp.sum(resid * resid, axis=(0, 1)) / 0.01

    kw = dict(n_samples=4, rw_scale=0.02, ode_weight=cfg["ode_weight"],
              ode_init=cfg["ode_init"], t_min=cfg["t_min"],
              t_max=cfg["t_max"], n_steps=cfg["n_steps"],
              prior_pars=cfg["prior_pars"], ode_flat=fitzhugh_flat,
              jac_flat=fitzhugh_jac_flat)
    # each card draws from the base key folded with its mesh position;
    # the one-card run replays the four lane groups with the same keys
    pf4, ll4, _ = run_chains_fused_sharded(
        loglik, init, jax.random.PRNGKey(2), mesh=mesh4,
        axis_name="chain", **kw)
    group = n_chains // 4
    with jax.default_device(one[0]):
        runs = [run_chains_fused(
            loglik, init[g * group:(g + 1) * group],
            jax.random.fold_in(jax.random.PRNGKey(2), g), **kw)
            for g in range(4)]
    pf1 = np.concatenate([np.asarray(r[0]) for r in runs], axis=1)
    check(bool(jnp.all(jnp.isfinite(ll4))), "run_chains_fused_sharded finite")
    check(sorted(set(on_each_device(ll4))) == [0, 1, 2, 3],
          "run_chains_fused_sharded did not spread over the four cards")
    d_fc = host_diff(pf4, pf1)
    check(d_fc <= 1e-3,
          f"run_chains_fused_sharded 4 vs 1 card positions differ {d_fc}")
    results["run_chains_fused_sharded_max_abs_diff"] = d_fc

    # 2. time-axis sharding: the iterated parallel-in-time solver
    tcfg = fitzhugh.setup(n_steps=4096, t_max=10.0, dtype=jnp.float32)
    tth = tcfg.pop("theta")
    t_mesh = make_mesh(n_devices=4, axis_name="time")
    mu_t4, _ = jax.jit(lambda pp, th: sharded_solve_mv_iterated(
        key=None, interrogate=interrogate_kramer, n_iter=3,
        warm_start=False, mesh=t_mesh, axis_name="time", theta=th,
        **{**tcfg, "prior_pars": pp}))(tcfg["prior_pars"], tth)
    with jax.default_device(one[0]):
        mu_t1, _ = jax.jit(lambda pp, th: solve_mv_iterated(
            key=None, interrogate=interrogate_kramer, n_iter=3,
            warm_start=False, theta=th,
            **{**tcfg, "prior_pars": pp}))(tcfg["prior_pars"], tth)
    d_t = host_diff(mu_t4[:, :, 0], mu_t1[:, :, 0])
    check(bool(jnp.all(jnp.isfinite(mu_t4))), "time-sharded solve finite")
    check(d_t <= 1e-3, f"time-sharded vs one card differ {d_t}")
    results["sharded_solve_mv_iterated_max_abs_diff"] = d_t

    # 3. state-axis sharding: the stationary dense large-state solver
    hcfg = heat.setup(d=128, n_deriv=3, n_steps=1000, dtype=jnp.float32)
    hcfg.pop("exact")
    p = hcfg.pop("n_deriv")
    s_mesh = make_mesh(n_devices=4, axis_name="state")
    mu_s4, _ = sharded_solve_mv_stationary(
        s_mesh, key=None, interrogate=interrogate_kramer, n_deriv=p,
        n_warm=32, **hcfg)
    with jax.default_device(one[0]):
        mu_s1, _ = jax.jit(lambda: solve_mv_stationary(
            key=None, interrogate=interrogate_kramer, n_deriv=p,
            n_warm=32, **hcfg))()
    # the solution components (0th derivatives, O(1) values); the
    # higher derivatives scale like d**2 and carry f32 reassociation noise
    # of the collectives in proportion
    d_s = host_diff(mu_s4[:, 0, ::p], mu_s1[:, 0, ::p])
    check(bool(jnp.all(jnp.isfinite(mu_s4))), "state-sharded solve finite")
    check(d_s <= 1e-4, f"state-sharded vs one card differ {d_s}")
    results["sharded_solve_mv_stationary_max_abs_diff"] = d_s
    return results


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the cross-card paths on 4 cards")
    args = parser.parse_args()

    import jax
    from rodeo_tpu.ops.profile import use_compile_cache

    # phase 0: the device — a GPU, or nothing
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX found {devs[0].platform!r} devices",
              file=sys.stderr)
        return 2
    cache = use_compile_cache(REPO)
    card = card_line()
    print(f"phase device: {card}; jax {jax.__version__}; "
          f"{len(devs)} x {devs[0].device_kind}; compile cache {cache}",
          flush=True)
    try:
        if args.four_cards:
            phase("four_cards", four_card_paths)
        else:
            truth = load_refs()
            ctrl = max_err_prefix(truth["solve_mu_10k_f32cpu"],
                                  truth["solve_mu_10k"], N_STEPS // 5)
            tol_solve = max(3.0 * ctrl, 0.05)
            phase("xla", lambda: phase_xla(truth, tol_solve))
            phase("fused", lambda: phase_fused(truth, tol_solve, ctrl))
            phase("likelihood", lambda: phase_likelihood(truth))
            phase("large_state", phase_large_state)
            phase("gpu_tests", phase_gpu_tests)
    except Exception as e:  # noqa: BLE001 - report and exit non-zero
        print(f"FAILED: {type(e).__name__}: {e}", file=sys.stderr,
              flush=True)
        return 1
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
