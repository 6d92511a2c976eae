r"""
Lockstep No-U-Turn Sampler (NUTS) over the fused gradient kernels.

The reference stops at random-walk pseudo-marginal MCMC
(``/root/reference/src/rodeo/inference/pseudo_marginal.py``); this module
adds the state-of-the-art gradient sampler on top of the tangent-augmented
fused kernels, in the same *lockstep* execution model as the MALA/HMC
runners of :mod:`rodeo_tpu.parallel.chains`: every leapfrog step of every
chain is ONE fused value+gradient kernel pass over the whole lane batch.

Dynamic trajectory lengths are the whole point of NUTS and the whole
problem for lockstep SIMD execution: a data-dependent ``while`` per chain
would serialize the lanes.  The lockstep answer is the **iterative**
tree-building algorithm (Phan & Pradhan 2019, *Iterative NUTS*; the same
scheme numpyro uses to stay XLA-compilable), made lane-parallel:

- every proposal runs a FIXED budget of :math:`2^{d_{max}} - 1` leapfrog
  steps for all lanes (static shapes, one ``lax.scan``), with per-lane
  ``done`` masks freezing chains whose trajectory terminated — terminated
  lanes ride along at zero algorithmic (not hardware) cost;
- the U-turn checks over all balanced subtrees run *iteratively* against
  :math:`O(d_{max})` checkpointed momenta via the trailing-bits trick
  (``lax.population_count`` instead of per-lane while loops);
- the next sample is drawn by progressive multinomial (reservoir)
  sampling along the trajectory — streaming, O(1) state per lane — with
  Betancourt's biased merge between doublings (favors the fresh subtree).

U-turn criterion: the generalized momentum-sum test
:math:`\langle r_{end}, \rho - (r_l + r_r)/2 \rangle \le 0` at either
trajectory end (rho = summed momenta), direction-symmetric and
position-free, so it needs only the checkpointed momenta.  A
per-dimension ``step_size`` acts as a diagonal mass preconditioner
exactly as in :func:`rodeo_tpu.parallel.chains.make_hmc_runner` (unit
momenta in the rescaled coordinates).

Positions may be any pytree with a leading lane axis (theta vectors,
MAGI paths, (path, theta) joints); internally everything runs on one
flattened ``(n_lane, D)`` float32 matrix.
"""
import math

import jax
import jax.numpy as jnp

__all__ = ["make_nuts_runner", "run_chains_nuts_fused",
           "run_chains_nuts_magi"]

_DIVERGENCE = 1000.0          # |delta energy| beyond this = divergent leaf


def _flatten_positions(positions):
    """Flatten a pytree with leading lane axis to ``(n_lane, D)`` f32;
    return (flat, unflatten)."""
    leaves, treedef = jax.tree.flatten(positions)
    n_lane = leaves[0].shape[0]
    shapes = [l.shape[1:] for l in leaves]
    sizes = [int(math.prod(s)) for s in shapes]
    flat = jnp.concatenate(
        [l.reshape(n_lane, -1).astype(jnp.float32) for l in leaves], axis=1)

    def unflatten(z):
        out, off = [], 0
        for s, sz in zip(shapes, sizes):
            out.append(z[..., off:off + sz].reshape(z.shape[:-1] + s))
            off += sz
        return jax.tree.unflatten(treedef, out)

    return flat, unflatten


def _is_turning(r_a, r_b, rho):
    """Generalized U-turn test between span ends ``r_a``/``r_b`` with
    span momentum sum ``rho`` — all ``(n_lane, D)``."""
    centered = rho - 0.5 * (r_a + r_b)
    t_a = jnp.sum(r_a * centered, axis=-1) <= 0.0
    t_b = jnp.sum(r_b * centered, axis=-1) <= 0.0
    return t_a | t_b


def make_nuts_runner(logpost_grad_fn, n_lane, n_samples, step_size,
                     max_depth=6):
    r"""
    Build a jitted lockstep NUTS runner:
    ``runner(init_positions, key, step_size_override=None) ->
    (positions, logdens, accept)``.

    Args:
        logpost_grad_fn (Callable): ``positions -> (logdens (n_lane,),
            grad)`` with ``grad`` shaped like the (pytree) positions —
            e.g. a closure over the fused ``*_fused_batch_grad`` kernels.
        n_lane (int): Number of chains (lanes).
        n_samples (int): NUTS proposals per run.  Each proposal costs
            ``2**max_depth - 1`` gradient evaluations for every lane
            (lockstep fixed budget).
        step_size (float | ndarray): Leapfrog step size; a vector is a
            per-dimension diagonal mass preconditioner.  Runtime
            overridable (traced) for dual-averaging adaptation via
            :func:`rodeo_tpu.parallel.chains.adapt_step_size`
            (``target_accept~0.8``).
        max_depth (int): Maximum tree depth (static).  Trajectories cap
            at ``2**max_depth`` states.

    Returns:
        (Callable): ``runner(init_positions, key, step_size=None)``
        returning ``positions (n_samples, n_lane, ...)`` (pytree like the
        input positions), final ``logdens (n_lane,)``, and the per-lane
        mean Metropolis-style acceptance statistic (the dual-averaging
        control signal, target ~0.8).
    """
    if max_depth < 1:
        raise ValueError(f"max_depth must be >= 1, got {max_depth}")

    def _leapfrog(flat_grad_fn, z, r, g, h):
        r1 = r + 0.5 * h * g
        z1 = z + h * r1
        ll1, g1 = flat_grad_fn(z1)
        r1 = r1 + 0.5 * h * g1
        return z1, r1, ll1, g1

    def _nuts_step(flat_grad_fn, eps, carry, step_key):
        z0, ll0, g0 = carry
        D = z0.shape[1]
        k_mom, k_loop = jax.random.split(step_key)
        r0 = jax.random.normal(k_mom, (n_lane, D), jnp.float32)
        H0 = ll0 - 0.5 * jnp.sum(r0 * r0, axis=-1)

        # trajectory state
        ends = dict(zl=z0, rl=r0, gl=g0, zr=z0, rr=r0, gr=g0)
        r_sum = r0
        prop = (z0, ll0, g0)
        log_w = jnp.zeros((n_lane,), jnp.float32)
        done = jnp.zeros((n_lane,), bool)
        acc_sum = jnp.zeros((n_lane,), jnp.float32)
        acc_cnt = jnp.zeros((n_lane,), jnp.float32)

        key = k_loop

        def make_doubling(j, k_dir, k_merge, leaf_keys):
            """Doubling j as a state -> state map, so each doubling can
            sit behind a ``lax.cond``: once EVERY lane has terminated,
            the remaining (largest!) doublings are skipped entirely —
            typical trees stop well short of ``max_depth``, and the
            skipped subtrees are where most of the fixed leapfrog budget
            lives."""

            def run_doubling(state):
                ends, r_sum, prop, log_w, done, acc_sum, acc_cnt = state
                direction = jnp.where(
                    jax.random.bernoulli(k_dir, shape=(n_lane,)),
                    1.0, -1.0)
                fwd = direction > 0
                h = (direction[:, None] * eps[None, :]).astype(jnp.float32)

                def pick(a, b):          # per-lane end selection
                    return jnp.where(fwd[:, None], a, b)

                edge = (pick(ends["zr"], ends["zl"]),
                        pick(ends["rr"], ends["rl"]),
                        pick(ends["gr"], ends["gl"]))
                sub = dict(
                    edge=edge,
                    r_sum=jnp.zeros_like(r_sum),
                    log_w=jnp.full((n_lane,), -jnp.inf, jnp.float32),
                    prop=(edge[0], jnp.zeros_like(prop[1]),
                          jnp.zeros_like(prop[2])),
                    turning=jnp.zeros((n_lane,), bool),
                    diverged=jnp.zeros((n_lane,), bool),
                    ckpt_r=jnp.zeros((max_depth, n_lane, D), jnp.float32),
                    ckpt_rs=jnp.zeros((max_depth, n_lane, D),
                                      jnp.float32),
                )

                def leaf_body(state, xs):
                    sub, acc_sum, acc_cnt = state
                    n, k_n = xs
                    active = ~(done | sub["turning"] | sub["diverged"])
                    z_e, r_e, g_e = sub["edge"]
                    z1, r1, ll1, g1 = _leapfrog(
                        flat_grad_fn, z_e, r_e, g_e, h)
                    lw = jnp.nan_to_num(
                        ll1 - 0.5 * jnp.sum(r1 * r1, axis=-1) - H0,
                        nan=-jnp.inf, posinf=-jnp.inf, neginf=-jnp.inf)
                    diverged = active & (lw < -_DIVERGENCE)
                    # accept statistic (dual-averaging control signal)
                    acc_sum = acc_sum + jnp.where(
                        active, jnp.exp(jnp.minimum(lw, 0.0)), 0.0)
                    acc_cnt = acc_cnt + active.astype(jnp.float32)
                    # streaming multinomial over the subtree's leaves
                    new_log_w = jnp.logaddexp(sub["log_w"], lw)
                    take_p = jnp.exp(lw - jnp.where(
                        jnp.isfinite(new_log_w), new_log_w, 0.0))
                    u = jax.random.uniform(k_n, (n_lane,), jnp.float32)
                    take = active & (u < take_p)

                    def sel(mask, a, b):
                        return jnp.where(
                            mask.reshape((n_lane,) + (1,) * (a.ndim - 1)),
                            a, b)

                    prop_z = sel(take, z1, sub["prop"][0])
                    prop_ll = jnp.where(take, ll1, sub["prop"][1])
                    prop_g = sel(take, g1, sub["prop"][2])
                    r_sum_sub = sub["r_sum"] + sel(active, r1,
                                                   jnp.zeros_like(r1))
                    # balanced-subtree U-turn bookkeeping (trailing-bit
                    # trick): even leaves open spans -> checkpoint
                    # (r, running sum); odd leaves close spans -> check
                    # against each open ckpt
                    idx_max = jax.lax.population_count(n >> 1)
                    n_close = jax.lax.population_count(n & ~(n + 1))
                    idx_min = idx_max - n_close + 1
                    is_even = (n & 1) == 0
                    old_r = jax.lax.dynamic_index_in_dim(
                        sub["ckpt_r"], idx_max, 0, keepdims=False)
                    old_rs = jax.lax.dynamic_index_in_dim(
                        sub["ckpt_rs"], idx_max, 0, keepdims=False)
                    store = is_even & active
                    ckpt_r = jax.lax.dynamic_update_index_in_dim(
                        sub["ckpt_r"], sel(store, r1, old_r), idx_max, 0)
                    ckpt_rs = jax.lax.dynamic_update_index_in_dim(
                        sub["ckpt_rs"], sel(store, r_sum_sub, old_rs),
                        idx_max, 0)
                    turning = sub["turning"]
                    for i in range(max_depth):
                        in_range = (~is_even) & (i >= idx_min) \
                            & (i <= idx_max)
                        span_sum = r_sum_sub - ckpt_rs[i] + ckpt_r[i]
                        t_i = _is_turning(ckpt_r[i], r1, span_sum)
                        turning = turning | (active & in_range & t_i)
                    new_sub = dict(
                        edge=(sel(active, z1, z_e), sel(active, r1, r_e),
                              sel(active, g1, g_e)),
                        r_sum=r_sum_sub,
                        log_w=jnp.where(active, new_log_w, sub["log_w"]),
                        prop=(prop_z, prop_ll, prop_g),
                        turning=turning,
                        diverged=sub["diverged"] | diverged,
                        ckpt_r=ckpt_r, ckpt_rs=ckpt_rs,
                    )
                    return (new_sub, acc_sum, acc_cnt), None

                n_leaf = 1 << j
                (sub, acc_sum, acc_cnt), _ = jax.lax.scan(
                    leaf_body, (sub, acc_sum, acc_cnt),
                    (jnp.arange(n_leaf, dtype=jnp.int32), leaf_keys))

                # merge the completed subtree into the trajectory
                ok = ~(done | sub["turning"] | sub["diverged"])

                def sel(mask, a, b):
                    return jnp.where(
                        mask.reshape((n_lane,) + (1,) * (a.ndim - 1)),
                        a, b)

                p_merge = jnp.exp(jnp.minimum(sub["log_w"] - log_w, 0.0))
                u = jax.random.uniform(k_merge, (n_lane,), jnp.float32)
                take = ok & (u < p_merge)
                prop = (sel(take, sub["prop"][0], prop[0]),
                        jnp.where(take, sub["prop"][1], prop[1]),
                        sel(take, sub["prop"][2], prop[2]))
                log_w = jnp.where(ok, jnp.logaddexp(log_w, sub["log_w"]),
                                  log_w)
                r_sum = jnp.where(ok[:, None], r_sum + sub["r_sum"],
                                  r_sum)
                e_z, e_r, e_g = sub["edge"]
                ends = dict(
                    zr=sel(ok & fwd, e_z, ends["zr"]),
                    rr=sel(ok & fwd, e_r, ends["rr"]),
                    gr=sel(ok & fwd, e_g, ends["gr"]),
                    zl=sel(ok & ~fwd, e_z, ends["zl"]),
                    rl=sel(ok & ~fwd, e_r, ends["rl"]),
                    gl=sel(ok & ~fwd, e_g, ends["gl"]),
                )
                turn_traj = _is_turning(ends["rl"], ends["rr"], r_sum)
                done = done | sub["turning"] | sub["diverged"] \
                    | (ok & turn_traj)
                return (ends, r_sum, prop, log_w, done, acc_sum, acc_cnt)

            return run_doubling

        state = (ends, r_sum, prop, log_w, done, acc_sum, acc_cnt)
        for j in range(max_depth):
            key, k_dir, k_merge, k_leaves = jax.random.split(key, 4)
            leaf_keys = jax.random.split(k_leaves, 1 << j)
            doubling = make_doubling(j, k_dir, k_merge, leaf_keys)
            state = jax.lax.cond(
                jnp.all(state[4]), lambda s: s, doubling, state)

        _ends, _r_sum, prop, _log_w, _done, acc_sum, acc_cnt = state
        accept = acc_sum / jnp.maximum(acc_cnt, 1.0)
        return (prop[0], prop[1], prop[2]), accept

    def _build_run(unflatten):
        @jax.jit
        def _run(flat0, key, eps):

            def flat_grad_fn(z):
                ll, g = logpost_grad_fn(unflatten(z))
                gflat, _ = _flatten_positions(g)
                return ll.astype(jnp.float32), gflat

            ll0, g0 = flat_grad_fn(flat0)
            keys = jax.random.split(key, n_samples)

            def body(carry, k):
                (z, ll, g), acc = _nuts_step(flat_grad_fn, eps, carry, k)
                return (z, ll, g), (z, acc)

            (zf, llf, gf), (zs, accs) = jax.lax.scan(
                body, (flat0, ll0, g0), keys)
            return zs, llf, jnp.mean(accs, axis=0)

        return _run

    # one compiled sampler per position-pytree STRUCTURE: the unflatten
    # closure is baked into its cache entry, so two pytrees that flatten
    # to the same (n_lane, D) but differ in structure get distinct
    # compiled programs instead of silently sharing a stale unflatten
    _run_cache = {}

    def run(init_positions, key, step_size_override=None):
        flat0, unflatten = _flatten_positions(init_positions)
        leaves, treedef = jax.tree.flatten(init_positions)
        cache_key = (treedef, tuple(leaf.shape[1:] for leaf in leaves))
        if cache_key not in _run_cache:
            _run_cache[cache_key] = _build_run(unflatten)
        _run = _run_cache[cache_key]
        D = flat0.shape[1]
        eps = jnp.asarray(
            step_size if step_size_override is None else step_size_override,
            jnp.float32)
        if eps.ndim == 0:
            eps = jnp.full((D,), eps, jnp.float32)
        elif eps.shape != (D,):
            raise ValueError(
                f"step_size must be scalar or shape ({D},) for the "
                f"flattened position space; got {eps.shape}")
        zs, llf, acc = _run(flat0, key, eps)
        return unflatten(zs), llf, acc

    return run


def run_chains_nuts_fused(init_positions, key, n_samples, step_size,
                          ode_weight, ode_init, t_min, t_max, n_steps,
                          prior_pars, obs_data, obs_times, obs_weight,
                          obs_var, ode_flat, jac_flat=None,
                          logprior_grad_fn=None, likelihood="fenrir",
                          max_depth=6):
    r"""
    Lockstep NUTS over the FENRIR (or DALTON) marginal likelihood: every
    leapfrog leaf of every chain is ONE tangent-augmented fused kernel
    pipeline; trajectory lengths adapt per lane via the iterative
    no-U-turn criterion under per-lane masks.

    Args as :func:`rodeo_tpu.parallel.chains.run_chains_hmc_fused` plus
    ``max_depth`` (static; each proposal costs ``2**max_depth - 1``
    gradient kernel passes).

    Returns:
        (tuple): ``positions (n_samples, n_lane, n_theta)``,
        ``logdens (n_lane,)``, per-lane mean acceptance statistic.
    """
    from rodeo_tpu.parallel.chains import _fused_theta_logpost_grad
    logpost_grad_fn = _fused_theta_logpost_grad(
        likelihood, init_positions.shape[0], ode_weight, ode_init,
        t_min, t_max, n_steps, prior_pars, obs_data, obs_times,
        obs_weight, obs_var, ode_flat, jac_flat, logprior_grad_fn)
    runner = make_nuts_runner(logpost_grad_fn, init_positions.shape[0],
                              n_samples, step_size, max_depth=max_depth)
    return runner(init_positions, key)


def run_chains_nuts_magi(init_subsets, key, n_samples, step_size,
                         ode_expand, n_active, prior_pars, dt,
                         theta_lanes=None, sig2_lanes=None,
                         extra_grad_fn=None, max_depth=6, **params):
    r"""
    Lockstep NUTS over the MAGI **path posterior** — the position is the
    thousands-dimensional latent path subset ``U`` (optionally jointly
    with a per-lane ``theta``), each leapfrog leaf one exact-adjoint
    kernel pipeline (:func:`rodeo_tpu.ops.pallas_magi.magi_fused_batch_grad`).
    At this dimensionality self-tuning trajectory lengths matter most:
    the no-U-turn criterion finds the integration horizon per lane that
    hand-picking ``n_leapfrog`` can only guess.

    Args as :func:`rodeo_tpu.parallel.chains.run_chains_mala_magi` plus
    ``max_depth`` (each proposal costs ``2**max_depth - 1`` adjoint
    pipelines); returns ``(positions, logdens, accept)``.
    """
    from rodeo_tpu.parallel.chains import _magi_logpost_grad
    logpost_grad_fn = _magi_logpost_grad(
        theta_lanes is not None, ode_expand, n_active, prior_pars, dt,
        sig2_lanes, extra_grad_fn, params)
    position0 = (init_subsets if theta_lanes is None
                 else (init_subsets, theta_lanes))
    runner = make_nuts_runner(logpost_grad_fn, init_subsets.shape[0],
                              n_samples, step_size, max_depth=max_depth)
    return runner(position0, key)
