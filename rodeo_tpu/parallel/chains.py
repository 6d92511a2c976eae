r"""
Sharded vmapped MCMC chains and parameter sweeps.

The pseudo-marginal MCMC stack (:mod:`rodeo_tpu.inference.pseudo_marginal`)
re-enters a full ODE solve per step per chain; scaling it means running many
chains at once.  Chains are vmapped into one XLA program (so per-block
:math:`q \times q` algebra batches into large ops) and the chain axis is
sharded over a device mesh with ``jax.jit`` + ``NamedSharding`` — pure data
parallelism over NVLink, zero cross-chip collectives inside a step.

These helpers realize BASELINE.json config #5 ("pseudo_marginal MCMC +
magi Markov-prior inference, vmapped chains").
"""
import jax
import jax.numpy as jnp

from rodeo_tpu.parallel.mesh import make_mesh, batch_sharding

__all__ = ["run_chains", "make_run_chains", "run_chains_fused",
           "make_mala_runner",
           "run_chains_mala_fused", "run_chains_mala_magi",
           "make_hmc_runner", "run_chains_hmc_fused",
           "run_chains_hmc_magi", "adapt_step_size",
           "magi_sig2_quadform", "run_chains_magi_gibbs",
           "sharded_loglik"]


def run_chains(alg, init_positions, key, n_samples,
               mesh=None, axis_name="chain"):
    r"""
    Run many MCMC chains in parallel, sharded over a device mesh.

    Args:
        alg (SamplingAlgorithm): e.g.
            :func:`rodeo_tpu.inference.pseudo_marginal.normal_random_walk`.
            ``alg.init(position, rng_key)`` / ``alg.step(rng_key, state)``
            must be vmappable (pseudo-marginal kernels are).
        init_positions (pytree): Initial positions with a leading chain
            axis of size ``n_chains``.
        key (PRNGKey): Base PRNG key.
        n_samples (int): Number of MCMC steps.
        mesh (jax.sharding.Mesh | None): Device mesh; default is a 1-D mesh
            over all devices named ``axis_name``.
        axis_name (str): Mesh axis to shard chains over.

    Returns:
        (tuple):
        - **positions** (pytree): Sampled positions with shape
          ``(n_samples, n_chains, ...)``.
        - **final_state** (RWAState): Final vmapped chain state.
        - **accept_rate** (ndarray(n_chains,)): Mean acceptance rate.
    """
    runner = make_run_chains(alg, n_samples, mesh=mesh,
                             axis_name=axis_name)
    return runner(init_positions, key)


def make_run_chains(alg, n_samples, mesh=None, axis_name="chain"):
    r"""
    Build the jitted multi-chain runner used by :func:`run_chains`
    (``runner(init_positions, key) -> (positions, final_state,
    accept_rate)``).

    Production loops (and anything that *times* the sampler) should
    create the runner ONCE and call it repeatedly — each
    :func:`run_chains` call builds fresh jitted closures, so its
    second invocation re-traces and re-compiles the whole scan.
    """
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)
    shard = batch_sharding(mesh, axis_name)

    @jax.jit
    def init_all(positions, chain_keys):
        return jax.vmap(alg.init)(positions, chain_keys)

    def one_step(state, step_key):
        n_chains = jax.tree_util.tree_leaves(state.position)[0].shape[0]
        step_keys = jax.random.split(step_key, n_chains)
        state, info = jax.vmap(alg.step)(step_keys, state)
        return state, (state.position, info.is_accepted)

    @jax.jit
    def _scan(state, key):
        step_keys = jax.random.split(key, n_samples)
        state, (positions, accepted) = jax.lax.scan(
            one_step, state, step_keys)
        return state, positions, jnp.mean(accepted, axis=0)

    def run(init_positions, key):
        n_chains = jax.tree_util.tree_leaves(init_positions)[0].shape[0]
        init_keys = jax.random.split(key, n_chains + 1)
        key, chain_keys = init_keys[0], init_keys[1:]
        state = init_all(
            jax.device_put(init_positions, shard),
            jax.device_put(chain_keys, shard))
        final_state, positions, accept_rate = _scan(state, key)
        return positions, final_state, accept_rate

    return run


def run_chains_fused(loglik_fn, init_positions, key, n_samples, rw_scale,
                     ode_weight, ode_init, t_min, t_max, n_steps,
                     prior_pars, ode_flat, jac_flat=None,
                     position_to_init=None):
    r"""
    Pseudo-marginal random-walk MCMC with every chain riding the fused
    lane-batched sampler: all ``n_lane`` chains advance in lockstep, and
    each step's likelihood estimate comes from ONE
    :func:`rodeo_tpu.ops.pallas_sim.solve_sim_fused_batch` call (the
    ~30-60x faster path vs. vmapping the XLA sampler per chain).

    Mathematically identical to vmapping
    :func:`rodeo_tpu.inference.pseudo_marginal.normal_random_walk` chains
    (independent normal proposals, Metropolis accept/reject on the
    auxiliary-path likelihood estimate; the rejected-state estimate is
    kept, as pseudo-marginal requires) — only the PRNG stream differs.

    Args:
        loglik_fn (Callable): ``loglik_fn(positions, paths) -> (n_lane,)``
            log-likelihood (+ log-prior) of each lane given its sampled ODE
            path; ``positions`` is ``(n_lane, n_theta)``, ``paths`` is
            ``(n_steps+1, n_block, q, n_lane)`` (lane axis LAST).
        init_positions (ndarray(n_lane, n_theta)): Initial chain positions.
        key (PRNGKey): Base PRNG key.
        n_samples (int): Number of MCMC steps.
        rw_scale (ndarray(n_theta,) | float): Random-walk proposal scale.
        ode_weight, ode_init, t_min, t_max, n_steps, prior_pars, ode_flat,
            jac_flat: Solver configuration (see
            :func:`rodeo_tpu.ops.pallas_kalman.solve_mv_fused_batch`);
            ``ode_init`` is shared across lanes unless ``position_to_init``
            is given.
        position_to_init (Callable | None): Optional
            ``position_to_init(positions) -> (n_lane, n_block, q)`` mapping
            each lane's parameters to its initial state (for models whose
            x0 depends on theta).

    Returns:
        (tuple):
        - **positions** (ndarray(n_samples, n_lane, n_theta)).
        - **logdens** (ndarray(n_lane,)): Final likelihood estimates.
        - **accept_rate** (ndarray(n_lane,)): Per-chain acceptance rate.
    """
    runner = make_chain_runner(
        loglik_fn=loglik_fn, n_lane=init_positions.shape[0],
        n_samples=n_samples, rw_scale=rw_scale, ode_weight=ode_weight,
        ode_init=ode_init, t_min=t_min, t_max=t_max, n_steps=n_steps,
        prior_pars=prior_pars, ode_flat=ode_flat, jac_flat=jac_flat,
        position_to_init=position_to_init)
    return runner(init_positions, key)


def make_chain_runner(loglik_fn, n_lane, n_samples, rw_scale,
                      ode_weight, ode_init, t_min, t_max, n_steps,
                      prior_pars, ode_flat, jac_flat=None,
                      position_to_init=None, interrogation=None):
    r"""
    Build the jitted lockstep-MCMC runner used by :func:`run_chains_fused`
    (``runner(init_positions, key) -> (positions, logdens, accept)``).

    Production loops should create the runner ONCE and call it repeatedly:
    each :func:`run_chains_fused` call builds (and re-traces) a fresh
    closure, which costs seconds of trace/lowering for long scans.
    """
    from rodeo_tpu.ops.pallas_sim import solve_sim_fused_batch

    n_theta = jnp.shape(jnp.asarray(rw_scale))[-1] \
        if jnp.ndim(jnp.asarray(rw_scale)) else None

    def inits_for(positions):
        if position_to_init is not None:
            return position_to_init(positions)
        return jnp.broadcast_to(ode_init, (n_lane,) + ode_init.shape)

    def estimate(positions, key):
        paths = solve_sim_fused_batch(
            key=key, thetas=positions, ode_weight=ode_weight,
            ode_inits=inits_for(positions), t_min=t_min, t_max=t_max,
            n_steps=n_steps, prior_pars=prior_pars, ode_flat=ode_flat,
            jac_flat=jac_flat,
            interrogation=interrogation)
        return loglik_fn(positions, paths)

    def one_step(scale, carry, step_key):
        pos, ll = carry
        k_prop, k_path, k_acc = jax.random.split(step_key, 3)
        prop = pos + scale * jax.random.normal(
            k_prop, pos.shape, jnp.float32)
        ll_prop = estimate(prop, k_path)
        log_u = jnp.log(jax.random.uniform(k_acc, (n_lane,), jnp.float32))
        # NaN-safe: a NaN estimate never accepts
        accept = log_u < jnp.nan_to_num(ll_prop - ll, nan=-jnp.inf)
        pos = jnp.where(accept[:, None], prop, pos)
        ll = jnp.where(accept, ll_prop, ll)
        return (pos, ll), (pos, accept)

    @jax.jit
    def _run(init_positions, key, scale):
        key_init, key_scan = jax.random.split(key)
        ll0 = estimate(init_positions.astype(jnp.float32), key_init)
        keys = jax.random.split(key_scan, n_samples)
        (pos, ll), (positions, accepted) = jax.lax.scan(
            lambda c, k: one_step(scale, c, k),
            (init_positions.astype(jnp.float32), ll0), keys)
        return positions, ll, jnp.mean(accepted.astype(jnp.float32), axis=0)

    def run(init_positions, key, scale=None):
        """``scale`` (runtime, traced) overrides the build-time
        ``rw_scale`` — re-tuning the proposal does not re-trace the
        scan."""
        s = jnp.asarray(rw_scale if scale is None else scale, jnp.float32)
        s = jnp.broadcast_to(s, init_positions.shape[-1:])
        return _run(init_positions, key, s)

    del n_theta
    return run


def make_mala_runner(logpost_grad_fn, n_lane, n_samples, step_size):
    r"""
    Build a jitted lockstep MALA (Metropolis-adjusted Langevin) runner:
    ``runner(init_positions, key) -> (positions, logdens, accept)``.

    Gradient-based MCMC is where the tangent-augmented fused kernels pay
    off: ONE ``*_fused_batch_grad`` call per step supplies the value and
    gradient for every chain, so the Langevin drift costs the same kernel
    pass a plain likelihood evaluation would (the reference needs
    reverse-mode through the whole solver scan — ~50x slower — and its
    f32 DALTON gradient is cancellation noise besides).

    Proposal ``x' = x + (eps^2/2) grad(x) + eps xi`` with the exact
    asymmetric-kernel Metropolis correction.

    Args:
        logpost_grad_fn (Callable): ``logpost_grad_fn(positions) ->
            (logdens (n_lane,), grad (n_lane, n_theta))`` — e.g. a closure
            over :func:`rodeo_tpu.ops.pallas_fenrir.fenrir_fused_batch_grad`
            plus a log-prior.
        n_lane (int): Number of chains.
        n_samples (int): Number of MCMC steps.
        step_size (float | ndarray(n_theta,)): Langevin step size
            (runtime-overridable, traced — no re-compile when tuning).

    Returns:
        (Callable): ``runner(init_positions, key, step_size=None)``.
    """

    # positions may be any pytree of arrays with a leading lane axis
    # (theta vectors, MAGI paths, (path, theta) tuples, ...); eps must
    # broadcast against each leaf's trailing dims (scalar always works)
    def _lane_bc(mask, leaf):
        return mask.reshape((n_lane,) + (1,) * (leaf.ndim - 1))

    def log_q(to, frm, g_frm, eps):
        def term(t, f, g):
            mu = f + 0.5 * eps * eps * g
            d = ((t - mu) ** 2 / (2.0 * eps * eps)).astype(jnp.float32)
            return jnp.sum(d.reshape(d.shape[0], -1), axis=-1)
        terms = jax.tree.leaves(jax.tree.map(term, to, frm, g_frm))
        return -sum(terms)

    def one_step(eps, carry, step_key):
        pos, ll, g = carry
        k_prop, k_acc = jax.random.split(step_key)
        leaves, treedef = jax.tree.flatten(pos)
        p_keys = jax.random.split(k_prop, len(leaves))
        xi = treedef.unflatten([
            jax.random.normal(k, l.shape, jnp.float32)
            for k, l in zip(p_keys, leaves)])
        prop = jax.tree.map(
            lambda p, gr, x: p + 0.5 * eps * eps * gr + eps * x,
            pos, g, xi)
        ll_prop, g_prop = logpost_grad_fn(prop)
        log_ratio = (ll_prop - ll
                     + log_q(pos, prop, g_prop, eps)
                     - log_q(prop, pos, g, eps))
        log_u = jnp.log(jax.random.uniform(k_acc, (n_lane,), jnp.float32))
        accept = log_u < jnp.nan_to_num(log_ratio, nan=-jnp.inf)
        pos = jax.tree.map(
            lambda p, q: jnp.where(_lane_bc(accept, p), q, p), pos, prop)
        ll = jnp.where(accept, ll_prop, ll)
        g = jax.tree.map(
            lambda p, q: jnp.where(_lane_bc(accept, p), q, p), g, g_prop)
        return (pos, ll, g), (pos, accept)

    @jax.jit
    def _run(init_positions, key, eps):
        pos0 = jax.tree.map(lambda p: p.astype(jnp.float32),
                            init_positions)
        ll0, g0 = logpost_grad_fn(pos0)
        keys = jax.random.split(key, n_samples)
        (pos, ll, g), (positions, accepted) = jax.lax.scan(
            lambda c, k: one_step(eps, c, k), (pos0, ll0, g0), keys)
        return positions, ll, jnp.mean(accepted.astype(jnp.float32),
                                       axis=0)

    def run(init_positions, key, step_size_override=None):
        eps = jnp.asarray(
            step_size if step_size_override is None else step_size_override,
            jnp.float32)
        if hasattr(init_positions, "ndim") and init_positions.ndim == 2 \
                and eps.ndim <= 1:
            eps = jnp.broadcast_to(eps, init_positions.shape[-1:])
        return _run(init_positions, key, eps)

    return run


def make_hmc_runner(logpost_grad_fn, n_lane, n_samples, step_size,
                    n_leapfrog=10):
    r"""
    Build a jitted lockstep HMC (Hamiltonian Monte Carlo) runner:
    ``runner(init_positions, key) -> (positions, logdens, accept)``.

    Each proposal integrates ``n_leapfrog`` leapfrog steps, so it costs
    ``n_leapfrog`` fused value+gradient kernel pipelines — but the
    proposal moves :math:`O(L \epsilon)` along the posterior instead of
    MALA's :math:`O(\epsilon)` diffusion, which is the better trade on
    correlated posteriors (ESS per gradient evaluation).  With
    ``n_leapfrog=1`` this is exactly MALA up to the identical-by-algebra
    proposal bookkeeping.

    A per-dimension ``step_size`` acts as a diagonal mass preconditioner:
    the kick ``p += (eps/2) * grad`` and drift ``q += eps * p`` with unit
    Gaussian momenta is leapfrog for the coordinate-rescaled target
    ``u = q / eps``, so detailed balance holds with the standard
    Metropolis correction on :math:`\Delta H`.

    Args:
        logpost_grad_fn (Callable): ``logpost_grad_fn(positions) ->
            (logdens (n_lane,), grad)`` with ``grad`` shaped like the
            (pytree) positions — e.g. a closure over
            :func:`rodeo_tpu.ops.pallas_fenrir.fenrir_fused_batch_grad`.
        n_lane (int): Number of chains.
        n_samples (int): Number of MCMC steps (proposals).
        step_size (float | ndarray(n_theta,)): Leapfrog step size
            (runtime-overridable, traced — no re-compile when tuning).
        n_leapfrog (int): Leapfrog steps per proposal (static).

    Returns:
        (Callable): ``runner(init_positions, key, step_size=None)``.
    """
    if n_leapfrog < 1:
        raise ValueError(f"n_leapfrog must be >= 1, got {n_leapfrog}")

    def _lane_bc(mask, leaf):
        return mask.reshape((n_lane,) + (1,) * (leaf.ndim - 1))

    def kinetic(p):
        terms = jax.tree.leaves(jax.tree.map(
            lambda l: jnp.sum((l * l).reshape(l.shape[0], -1), axis=-1),
            p))
        return 0.5 * sum(terms)

    def one_step(eps, carry, step_key):
        pos, ll, g = carry
        k_mom, k_acc = jax.random.split(step_key)
        leaves, treedef = jax.tree.flatten(pos)
        m_keys = jax.random.split(k_mom, len(leaves))
        mom = treedef.unflatten([
            jax.random.normal(k, l.shape, jnp.float32)
            for k, l in zip(m_keys, leaves)])
        # leapfrog: the first half kick reuses the carried gradient; the
        # scan body does drift -> eval -> full kick, and the trailing
        # half kick is recovered by undoing half of the last full kick
        p_half = jax.tree.map(lambda pp, gg: pp + 0.5 * eps * gg, mom, g)

        def lf_body(c, _):
            q, p, _ll, _g = c
            q = jax.tree.map(lambda qq, pp: qq + eps * pp, q, p)
            ll_q, g_q = logpost_grad_fn(q)
            p = jax.tree.map(lambda pp, gg: pp + eps * gg, p, g_q)
            return (q, p, ll_q, g_q), None

        (q, p, ll_prop, g_prop), _ = jax.lax.scan(
            lf_body, (pos, p_half, ll, g), None, length=n_leapfrog)
        p = jax.tree.map(lambda pp, gg: pp - 0.5 * eps * gg, p, g_prop)
        log_ratio = ll_prop - ll + kinetic(mom) - kinetic(p)
        log_u = jnp.log(jax.random.uniform(k_acc, (n_lane,), jnp.float32))
        # NaN-safe: a diverged trajectory never accepts
        accept = log_u < jnp.nan_to_num(log_ratio, nan=-jnp.inf)
        pos = jax.tree.map(
            lambda a, b: jnp.where(_lane_bc(accept, a), b, a), pos, q)
        ll = jnp.where(accept, ll_prop, ll)
        g = jax.tree.map(
            lambda a, b: jnp.where(_lane_bc(accept, a), b, a), g, g_prop)
        return (pos, ll, g), (pos, accept)

    @jax.jit
    def _run(init_positions, key, eps):
        pos0 = jax.tree.map(lambda p: p.astype(jnp.float32),
                            init_positions)
        ll0, g0 = logpost_grad_fn(pos0)
        keys = jax.random.split(key, n_samples)
        (pos, ll, g), (positions, accepted) = jax.lax.scan(
            lambda c, k: one_step(eps, c, k), (pos0, ll0, g0), keys)
        return positions, ll, jnp.mean(accepted.astype(jnp.float32),
                                       axis=0)

    def run(init_positions, key, step_size_override=None):
        eps = jnp.asarray(
            step_size if step_size_override is None else step_size_override,
            jnp.float32)
        if hasattr(init_positions, "ndim") and init_positions.ndim == 2 \
                and eps.ndim <= 1:
            eps = jnp.broadcast_to(eps, init_positions.shape[-1:])
        return _run(init_positions, key, eps)

    return run


def adapt_step_size(runner, init_positions, key, init_step,
                    target_accept=0.57, n_windows=15, decay=0.75,
                    gamma=0.05, t0=10.0):
    r"""
    Dual-averaging step-size adaptation (Nesterov primal-dual as used by
    Stan/NUTS, Hoffman & Gelman 2014 §3.2) for the lockstep
    MALA/HMC runners: repeatedly runs short windows, drives the mean
    acceptance toward ``target_accept`` by adapting a log step-size
    multiplier, and warm-starts each window from the previous one's final
    positions.  Because the runners take ``step_size_override`` as a
    traced value, the whole adaptation re-uses ONE compiled program.

    Args:
        runner (Callable): From :func:`make_mala_runner` /
            :func:`make_hmc_runner`; its build-time ``n_samples`` is the
            adaptation window length (32-64 works well).
        init_positions (pytree): Initial positions (leading lane axis).
        key (PRNGKey): Base PRNG key.
        init_step (float | ndarray): Initial step size; a per-dimension
            vector is scaled by one shared adapted multiplier.
        target_accept (float): ~0.57 for MALA, ~0.8 for HMC.
        n_windows (int): Adaptation windows.
        decay, gamma, t0: Dual-averaging constants (paper defaults).

    Returns:
        (tuple):
        - **step_size** (ndarray): Adapted step size (averaged iterate).
        - **positions** (pytree): Warmed-up positions for the main run.
        - **accept** (float): Mean acceptance of a final evaluation
          window run AT the returned step size (the adaptation windows
          themselves run at the noisy non-averaged iterate).
    """
    import math
    base = jnp.asarray(init_step, jnp.float32)
    mu = math.log(10.0)        # shrink target: 10x the initial step
    log_eps, log_eps_bar, h_bar = 0.0, 0.0, 0.0
    pos = init_positions
    for t in range(1, n_windows + 1):
        key, sub = jax.random.split(key)
        positions, _ll, acc = runner(
            pos, sub, step_size_override=base * math.exp(log_eps))
        a = float(jnp.mean(acc))
        h_bar = (1.0 - 1.0 / (t + t0)) * h_bar \
            + (target_accept - a) / (t + t0)
        log_eps = mu - math.sqrt(t) / gamma * h_bar
        eta = t ** (-decay)
        log_eps_bar = eta * log_eps + (1.0 - eta) * log_eps_bar
        pos = jax.tree.map(lambda p: p[-1], positions)
    eps_final = base * math.exp(log_eps_bar)
    key, sub = jax.random.split(key)
    positions, _ll, acc = runner(pos, sub, step_size_override=eps_final)
    pos = jax.tree.map(lambda p: p[-1], positions)
    return eps_final, pos, float(jnp.mean(acc))


def adapt_warmup(runner, init_positions, key, init_step,
                 target_accept=0.8, n_windows=8, n_var_windows=3):
    r"""
    Stan-style two-phase warmup for the lockstep MALA/HMC/NUTS runners:
    dual-averaging step-size adaptation *plus* diagonal mass-matrix
    estimation.

    Phase 1 dual-averages a scalar step size at identity mass
    (:func:`adapt_step_size`).  Phase 2 samples ``n_var_windows`` windows
    at that step, estimates the per-dimension posterior standard
    deviation across (samples x lanes), and sets the per-dimension step
    ``eps_d \propto std_d`` — for these runners a per-dimension step IS a
    diagonal mass preconditioner (the kick/drift with unit momenta is
    leapfrog for the ``u = q/eps`` rescaled target).  The std vector is
    geometric-mean normalized so its overall magnitude stays comparable
    to the phase-1 scalar, then phase 3 re-runs dual averaging on the
    shared multiplier of the new base vector.

    Args:
        runner (Callable): From :func:`make_mala_runner` /
            :func:`make_hmc_runner` /
            :func:`rodeo_tpu.parallel.nuts.make_nuts_runner`; positions
            must be plain ``(n_lane, n_dim)`` arrays (the per-dimension
            step plumbing is array-only).
        init_positions (ndarray(n_lane, n_dim)): Initial positions.
        key (PRNGKey): Base PRNG key.
        init_step (float): Initial scalar step size.
        target_accept (float): ~0.57 for MALA, ~0.8 for HMC/NUTS.
        n_windows (int): Dual-averaging windows per phase (phase 3 uses
            ``max(4, n_windows // 2)``).
        n_var_windows (int): Sampling windows for the variance estimate.

    Returns:
        (tuple): adapted per-dimension ``step_size (n_dim,)``, warmed-up
        ``positions``, and the final-window mean acceptance.
    """
    if getattr(init_positions, "ndim", None) != 2:
        raise ValueError(
            "adapt_warmup requires plain (n_lane, n_dim) positions; "
            "use adapt_step_size for pytree positions")
    k1, k2, k3 = jax.random.split(key, 3)
    eps1, pos, _ = adapt_step_size(
        runner, init_positions, k1, init_step,
        target_accept=target_accept, n_windows=n_windows)
    draws = []
    for _ in range(n_var_windows):
        k2, sub = jax.random.split(k2)
        positions, _ll, _acc = runner(pos, sub, step_size_override=eps1)
        pos = positions[-1]
        draws.append(positions)
    samples = jnp.concatenate(draws, axis=0)          # (W*n, n_lane, d)
    std = jnp.std(samples.reshape(-1, samples.shape[-1]), axis=0)
    std = jnp.maximum(std, 1e-6 * jnp.max(std))
    scale = std / jnp.exp(jnp.mean(jnp.log(std)))
    base = jnp.asarray(eps1, jnp.float32) * scale
    return adapt_step_size(
        runner, pos, k3, base, target_accept=target_accept,
        n_windows=max(4, n_windows // 2))


def run_chains_mala_fused(init_positions, key, n_samples, step_size,
                          ode_weight, ode_init, t_min, t_max, n_steps,
                          prior_pars, obs_data, obs_times, obs_weight,
                          obs_var, ode_flat, jac_flat=None,
                          logprior_grad_fn=None, likelihood="fenrir"):
    r"""
    Lockstep MALA over the FENRIR (or DALTON) marginal likelihood, every
    chain riding ONE tangent-augmented fused kernel pipeline per step.

    Args:
        likelihood (str): ``"fenrir"`` or ``"dalton"``.
        logprior_grad_fn (Callable | None): Optional
            ``logprior_grad_fn(positions) -> (logp (n_lane,),
            grad (n_lane, n_theta))`` added to the likelihood (flat prior
            otherwise).
        (other args as :func:`run_chains_fused` /
        :func:`rodeo_tpu.ops.pallas_fenrir.fenrir_fused_batch_grad`)

    Returns:
        (tuple): ``positions (n_samples, n_lane, n_theta)``,
        ``logdens (n_lane,)``, ``accept_rate (n_lane,)``.
    """
    logpost_grad_fn = _fused_theta_logpost_grad(
        likelihood, init_positions.shape[0], ode_weight, ode_init,
        t_min, t_max, n_steps, prior_pars, obs_data, obs_times,
        obs_weight, obs_var, ode_flat, jac_flat, logprior_grad_fn)
    runner = make_mala_runner(logpost_grad_fn, init_positions.shape[0],
                              n_samples, step_size)
    return runner(init_positions, key)


def run_chains_hmc_fused(init_positions, key, n_samples, step_size,
                         ode_weight, ode_init, t_min, t_max, n_steps,
                         prior_pars, obs_data, obs_times, obs_weight,
                         obs_var, ode_flat, jac_flat=None,
                         logprior_grad_fn=None, likelihood="fenrir",
                         n_leapfrog=10):
    r"""
    Lockstep HMC over the FENRIR (or DALTON) marginal likelihood: each
    of the ``n_leapfrog`` leapfrog steps per proposal costs ONE
    tangent-augmented fused kernel pipeline for all chains.

    Args as :func:`run_chains_mala_fused` plus ``n_leapfrog``; returns
    ``(positions, logdens, accept_rate)``.
    """
    logpost_grad_fn = _fused_theta_logpost_grad(
        likelihood, init_positions.shape[0], ode_weight, ode_init,
        t_min, t_max, n_steps, prior_pars, obs_data, obs_times,
        obs_weight, obs_var, ode_flat, jac_flat, logprior_grad_fn)
    runner = make_hmc_runner(logpost_grad_fn, init_positions.shape[0],
                             n_samples, step_size, n_leapfrog=n_leapfrog)
    return runner(init_positions, key)


def _fused_theta_logpost_grad(likelihood, n_lane, ode_weight, ode_init,
                              t_min, t_max, n_steps, prior_pars, obs_data,
                              obs_times, obs_weight, obs_var, ode_flat,
                              jac_flat, logprior_grad_fn):
    """Shared ``logpost_grad_fn`` closure over the fused fenrir/dalton
    value+gradient kernels (used by the MALA and HMC wrappers)."""
    from rodeo_tpu.ops.pallas_fenrir import fenrir_fused_batch_grad
    from rodeo_tpu.ops.pallas_dalton import dalton_fused_batch_grad
    grad_fns = {"fenrir": fenrir_fused_batch_grad,
                "dalton": dalton_fused_batch_grad}
    if likelihood not in grad_fns:
        raise NotImplementedError(
            f"unknown likelihood {likelihood!r}; expected one of "
            f"{sorted(grad_fns)}")
    fused_grad = grad_fns[likelihood]
    inits = jnp.broadcast_to(ode_init, (n_lane,) + ode_init.shape)

    def logpost_grad_fn(positions):
        ll, g = fused_grad(
            thetas=positions, ode_weight=ode_weight, ode_inits=inits,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            prior_pars=prior_pars, obs_data=obs_data, obs_times=obs_times,
            obs_weight=obs_weight, obs_var=obs_var, ode_flat=ode_flat,
            jac_flat=jac_flat)
        if logprior_grad_fn is not None:
            lp, gp = logprior_grad_fn(positions)
            ll, g = ll + lp, g + gp
        return ll, g

    return logpost_grad_fn


def run_chains_mala_magi(init_subsets, key, n_samples, step_size,
                         ode_expand, n_active, prior_pars, dt,
                         theta_lanes=None, sig2_lanes=None,
                         extra_grad_fn=None, **params):
    r"""
    Lockstep MALA over the MAGI **path posterior**: the MCMC position is
    the latent path subset ``U`` itself (optionally jointly with a
    per-lane ``theta``), and every step's Langevin drift costs one fused
    forward+adjoint kernel pipeline for all chains
    (:func:`rodeo_tpu.ops.pallas_magi.magi_fused_batch_grad`).

    This is the solver-free inference mode of the reference
    (``src/rodeo/inference/magi.py``) driven at fused-kernel speed —
    there is no per-step ODE solve at all, and reverse mode over the
    thousands-dimensional path state comes from the filter's exact
    adjoint rather than XLA autodiff.

    Args:
        init_subsets (ndarray(n_lane, n_steps+1, n_block, n_sub)):
            Initial per-chain paths.
        theta_lanes (ndarray(n_lane, ...) | None): When given, theta is
            sampled JOINTLY with the path (position = ``(U, theta)``),
            entering via ``ode_expand(subset, theta=..., **params)``.
        extra_grad_fn (Callable | None): ``extra_grad_fn(position) ->
            (logp (n_lane,), grad_like_position)`` for the rest of the
            posterior — typically the observation log-likelihood of
            ``Y | U`` plus parameter priors (MAGI's log-density alone is
            only the ODE-prior factor).
        step_size (float): Langevin step size (scalar; the position is a
            pytree).
        (other args as :func:`rodeo_tpu.ops.pallas_magi.magi_fused_batch`)

    Returns:
        (tuple): ``positions`` (pytree like the position with a leading
        ``(n_samples,)`` axis), ``logdens (n_lane,)``,
        ``accept_rate (n_lane,)``.
    """
    logpost_grad_fn = _magi_logpost_grad(
        theta_lanes is not None, ode_expand, n_active, prior_pars, dt,
        sig2_lanes, extra_grad_fn, params)
    position0 = (init_subsets if theta_lanes is None
                 else (init_subsets, theta_lanes))
    runner = make_mala_runner(logpost_grad_fn, init_subsets.shape[0],
                              n_samples, step_size)
    return runner(position0, key)


def run_chains_hmc_magi(init_subsets, key, n_samples, step_size,
                        ode_expand, n_active, prior_pars, dt,
                        theta_lanes=None, sig2_lanes=None,
                        extra_grad_fn=None, n_leapfrog=10, **params):
    r"""
    Lockstep HMC over the MAGI **path posterior** — the position is the
    thousands-dimensional latent path subset ``U`` (optionally jointly
    with a per-lane ``theta``), and each leapfrog step's gradient comes
    from the filter's exact adjoint kernel
    (:func:`rodeo_tpu.ops.pallas_magi.magi_fused_batch_grad`).  HMC is
    the natural sampler at this dimensionality: its coherent
    :math:`O(L\epsilon)` trajectories beat MALA's diffusive moves, at
    ``n_leapfrog`` adjoint pipelines per proposal.

    Args as :func:`run_chains_mala_magi` plus ``n_leapfrog``; returns
    ``(positions, logdens, accept_rate)``.
    """
    logpost_grad_fn = _magi_logpost_grad(
        theta_lanes is not None, ode_expand, n_active, prior_pars, dt,
        sig2_lanes, extra_grad_fn, params)
    position0 = (init_subsets if theta_lanes is None
                 else (init_subsets, theta_lanes))
    runner = make_hmc_runner(logpost_grad_fn, init_subsets.shape[0],
                             n_samples, step_size, n_leapfrog=n_leapfrog)
    return runner(position0, key)


def magi_sig2_quadform(ld_s, ld_2s, sig2_lanes, n_steps, n_block,
                       n_active):
    r"""
    Recover the per-lane :math:`(Q, D)` of the MAGI log-density's exact
    :math:`\sigma^2` dependence from two evaluations.

    Every covariance in the MAGI filter is linear in the process-noise
    multiplier (the active rows are *exact* observations and the initial
    state has zero variance), so for each lane

    .. math:: \log p(U \mid \sigma^2 = s)
        = -\tfrac{Q(U)}{2s} - \tfrac{D}{2}\log s + C(U),

    with :math:`D = n_{steps}\, n_{block}\, n_{active}` (the count of
    Gaussian-conditioned dimensions; validated numerically to 1e-10
    against an ``(s^{-1}, \log s, 1)`` least-squares fit) and
    :math:`Q \ge 0` the total forecast quadratic form at ``s = 1``.
    Two evaluations at ``s`` and ``2s`` therefore determine ``Q``:

    .. math:: Q = 4s\,[\,ld(2s) - ld(s) + \tfrac{D}{2}\log 2\,].

    Args:
        ld_s (ndarray(n_lane,)): Log-density at ``sig2_lanes``.
        ld_2s (ndarray(n_lane,)): Log-density at ``2 * sig2_lanes``.
        sig2_lanes (ndarray(n_lane,)): The base multiplier ``s``.
        n_steps, n_block, n_active (int): Grid/model dimensions.

    Returns:
        (tuple): ``Q (ndarray(n_lane,))``, ``D (float)``.
    """
    d_dim = float(n_steps * n_block * n_active)
    q = 4.0 * sig2_lanes * (ld_2s - ld_s + 0.5 * d_dim * jnp.log(2.0))
    return jnp.maximum(q, 0.0), d_dim


def run_chains_magi_gibbs(init_subsets, key, n_sweeps, step_size,
                          ode_expand, n_active, prior_pars, dt,
                          sig2_init, sig2_prior_shape=2.0,
                          sig2_prior_rate=1.0, n_inner=5,
                          extra_grad_fn=None, **params):
    r"""
    Joint MAGI inference over (path, :math:`\sigma^2`): each sweep runs
    ``n_inner`` lockstep MALA steps on the latent path ``U`` given the
    per-lane :math:`\sigma^2` (fused forward+adjoint pipelines), then a
    **conjugate Gibbs draw** of :math:`\sigma^2 \mid U`:

    .. math:: \sigma^2 \mid U \sim
        \text{InvGamma}(a_0 + D/2,\; b_0 + Q(U)/2),

    with :math:`(Q, D)` from :func:`magi_sig2_quadform` (one extra
    value-kernel evaluation per sweep — the MALA step already holds
    the log-density at the current :math:`\sigma^2`).  This completes
    the design-note recommendation that :math:`\sigma^2` move by Gibbs
    rather than by gradient (it has no adjoint path).

    The ODE-prior factor alone does not identify :math:`\sigma^2` and
    the data enters through ``extra_grad_fn``, so choose a proper
    InvGamma prior (``sig2_prior_shape/rate``; mean = rate/(shape-1)).

    In float32, ``Q`` comes from a difference of two O(|ld|)-magnitude
    values; far from the ODE manifold (early iterations) its relative
    precision degrades — harmless for Gibbs (the conditional is then
    diffuse anyway), exact near equilibrium where it matters.

    Args:
        init_subsets (ndarray(n_lane, n_steps+1, n_block, n_sub)).
        sig2_init (ndarray(n_lane,) | float): Initial multipliers.
        n_inner (int): MALA steps on ``U`` per sigma^2 draw.
        extra_grad_fn (Callable | None): As
            :func:`run_chains_mala_magi` (observation likelihood of
            ``Y | U`` — it must not depend on :math:`\sigma^2`).
        (other args as :func:`run_chains_mala_magi`)

    Returns:
        (tuple):
        - **positions** (ndarray(n_sweeps, n_lane, n_steps+1, n_block,
          n_sub)): Path draw after each sweep.
        - **sig2s** (ndarray(n_sweeps, n_lane)): Sigma^2 draw per sweep.
        - **logdens** (ndarray(n_lane,)): Final log-densities.
        - **accept_rate** (ndarray(n_lane,)): MALA acceptance on ``U``.
    """
    if n_inner < 1:
        raise ValueError(f"n_inner must be >= 1, got {n_inner}")
    from rodeo_tpu.ops.pallas_magi import magi_fused_batch, \
        magi_fused_batch_grad
    n_lane, n_grid = init_subsets.shape[0], init_subsets.shape[1]
    n_block = init_subsets.shape[2]
    n_steps = n_grid - 1

    def ld_at(u, sig2):
        return magi_fused_batch(
            u, ode_expand, n_active, prior_pars, dt, sig2_lanes=sig2, **params)

    def logpost_grad(u, sig2):
        ld, g_u = magi_fused_batch_grad(
            u, ode_expand, n_active, prior_pars, dt, sig2_lanes=sig2, **params)
        if extra_grad_fn is not None:
            lp, gp = extra_grad_fn(u)
            ld, g_u = ld + lp, g_u + gp
        return ld, g_u

    eps = jnp.asarray(step_size, jnp.float32)

    def mala_step(carry, step_key, sig2):
        pos, ll, g = carry
        k_prop, k_acc = jax.random.split(step_key)
        xi = jax.random.normal(k_prop, pos.shape, jnp.float32)
        prop = pos + 0.5 * eps * eps * g + eps * xi
        ll_prop, g_prop = logpost_grad(prop, sig2)

        def log_q(to, frm, g_frm):
            mu_q = frm + 0.5 * eps * eps * g_frm
            d = ((to - mu_q) ** 2 / (2.0 * eps * eps))
            return -jnp.sum(d.reshape(d.shape[0], -1), axis=-1)

        log_ratio = (ll_prop - ll + log_q(pos, prop, g_prop)
                     - log_q(prop, pos, g))
        log_u = jnp.log(jax.random.uniform(k_acc, (n_lane,), jnp.float32))
        accept = log_u < jnp.nan_to_num(log_ratio, nan=-jnp.inf)
        bc = accept.reshape((n_lane,) + (1,) * (pos.ndim - 1))
        return (jnp.where(bc, prop, pos), jnp.where(accept, ll_prop, ll),
                jnp.where(bc, g_prop, g)), accept

    def one_sweep(carry, sweep_key):
        pos, ll, g, sig2 = carry
        k_inner, k_gibbs = jax.random.split(sweep_key)
        inner_keys = jax.random.split(k_inner, n_inner)
        (pos, ll, g), acc = jax.lax.scan(
            lambda c, k: mala_step(c, k, sig2), (pos, ll, g), inner_keys)
        # conjugate sigma^2 draw; `ll` may include extra_grad_fn's
        # sigma^2-free terms — they cancel in the two-point difference
        # only if present in both, so re-evaluate the prior factor alone
        ld_s = ld_at(pos, sig2)
        ld_2s = ld_at(pos, 2.0 * sig2)
        q_lane, d_dim = magi_sig2_quadform(
            ld_s, ld_2s, sig2, n_steps, n_block, n_active)
        shape = sig2_prior_shape + 0.5 * d_dim
        rate = sig2_prior_rate + 0.5 * q_lane
        gam = jax.random.gamma(k_gibbs, shape, (n_lane,), jnp.float32)
        sig2_new = rate / gam
        # refresh the carried value/gradient at the new sigma^2
        ll, g = logpost_grad(pos, sig2_new)
        return (pos, ll, g, sig2_new), (pos, sig2_new, acc)

    @jax.jit
    def _run(u0, key, sig2_0):
        ll0, g0 = logpost_grad(u0, sig2_0)
        keys = jax.random.split(key, n_sweeps)
        (pos, ll, g, sig2), (positions, sig2s, accepted) = jax.lax.scan(
            one_sweep, (u0, ll0, g0, sig2_0), keys)
        acc = jnp.mean(
            accepted.astype(jnp.float32).reshape(-1, n_lane), axis=0)
        return positions, sig2s, ll, acc

    sig2_0 = jnp.broadcast_to(
        jnp.asarray(sig2_init, jnp.float32), (n_lane,))
    return _run(init_subsets.astype(jnp.float32), key, sig2_0)


def _magi_logpost_grad(joint_theta, ode_expand, n_active, prior_pars, dt,
                       sig2_lanes, extra_grad_fn,
                       params):
    """Shared path-posterior ``logpost_grad_fn`` closure over the MAGI
    forward+adjoint kernels (used by the MALA and HMC wrappers)."""
    from rodeo_tpu.ops.pallas_magi import magi_fused_batch_grad

    def logpost_grad_fn(position):
        if not joint_theta:
            ld, g_u = magi_fused_batch_grad(
                position, ode_expand, n_active, prior_pars, dt,
                sig2_lanes=sig2_lanes,
                **params)
            grad = g_u
        else:
            u, th = position
            ld, g_u, g_th = magi_fused_batch_grad(
                u, ode_expand, n_active, prior_pars, dt,
                theta_lanes=th, sig2_lanes=sig2_lanes, **params)
            grad = (g_u, g_th)
        if extra_grad_fn is not None:
            lp, gp = extra_grad_fn(position)
            ld = ld + lp
            grad = jax.tree.map(lambda a, b: a + b, grad, gp)
        return ld, grad

    return logpost_grad_fn


def sharded_loglik(loglik_fn, thetas, keys=None, mesh=None,
                   axis_name="batch"):
    r"""
    Evaluate a log-likelihood (e.g. fenrir/dalton closure) over a batch of
    parameter candidates, vmapped and sharded over the mesh.

    Args:
        loglik_fn (Callable): ``loglik_fn(theta)`` or
            ``loglik_fn(theta, key)`` if ``keys`` is given.
        thetas (pytree): Parameter batch with a leading axis.
        keys (ndarray | None): Optional per-candidate PRNG keys.
        mesh, axis_name: As in :func:`run_chains`.

    Returns:
        (ndarray): Log-likelihood values, one per candidate.
    """
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)
    shard = batch_sharding(mesh, axis_name)
    thetas = jax.device_put(thetas, shard)
    if keys is None:
        fn = jax.jit(jax.vmap(loglik_fn))
        return fn(thetas)
    keys = jax.device_put(keys, shard)
    fn = jax.jit(jax.vmap(loglik_fn))
    return fn(thetas, keys)
