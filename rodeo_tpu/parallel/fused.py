r"""
Multi-chip sharding of the lane-batched fused kernels.

The lane axis of the fused Pallas pipelines (parameter candidates / MCMC
chains) is embarrassingly parallel, so it shards over a 1-D device mesh
with ``shard_map``: each chip runs the SAME fused kernel pipeline on its
lane group, with zero collectives — aggregate throughput scales linearly
over NVLink.  All other operands are replicated.

These wrappers keep the single-chip calling conventions (lane axis first
in ``thetas``/``ode_inits``, LAST in outputs); the lane count must divide
by the mesh size.
"""
import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
try:
    from jax import shard_map                      # jax >= 0.8
except ImportError:                                # pragma: no cover
    from jax.experimental.shard_map import shard_map

from rodeo_tpu.parallel.mesh import make_mesh

__all__ = ["sharded_solve_mv_fused_batch", "sharded_fenrir_fused_batch",
           "sharded_dalton_fused_batch", "sharded_daltonng_fused_batch",
           "sharded_basic_fused_batch", "sharded_solve_sim_fused_batch",
           "sharded_fenrir_fused_batch_grad",
           "sharded_dalton_fused_batch_grad",
           "sharded_basic_fused_batch_grad",
           "sharded_magi_fused_batch",
           "sharded_magi_fused_batch_grad",
           "run_chains_fused_sharded"]


def _lane_sharded(fn, mesh, axis_name, n_array_outs, out_lane_axis):
    """shard_map a lane-batched kernel wrapper: arg 0 (thetas) and arg 1
    (ode_inits) split on their leading lane axis, everything else
    replicated; outputs split on ``out_lane_axis``."""
    def wrapped(thetas, ode_inits, *reps):
        in_specs = (P(axis_name), P(axis_name)) + (P(),) * len(reps)
        out_lane = P(*([None] * out_lane_axis + [axis_name]))
        out_specs = tuple([out_lane] * n_array_outs)
        if n_array_outs == 1:
            out_specs = out_specs[0]
        return shard_map(
            functools.partial(fn), mesh=mesh,
            in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )(thetas, ode_inits, *reps)
    return wrapped


def sharded_solve_mv_fused_batch(thetas, ode_weight, ode_inits,
                                 t_min, t_max, n_steps, prior_pars,
                                 ode_flat, jac_flat=None,
                                 mesh=None, axis_name="batch",
                                 kalman_type="standard"):
    r"""
    :func:`rodeo_tpu.ops.pallas_kalman.solve_mv_fused_batch` with the lane
    axis sharded over a device mesh (lane groups per chip, no
    collectives).

    Returns the same ``(mean, var_packed)`` with the lane axis last,
    globally sharded.
    """
    from rodeo_tpu.ops import pallas_kalman as pk
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)

    def local(th, x0, W):
        return pk.solve_mv_fused_batch(
            thetas=th, ode_weight=W, ode_inits=x0,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            prior_pars=prior_pars, ode_flat=ode_flat, jac_flat=jac_flat,
            kalman_type=kalman_type)

    return _lane_sharded(local, mesh, axis_name, 2, 3)(
        thetas, ode_inits, ode_weight)


def sharded_fenrir_fused_batch(thetas, ode_weight, ode_inits,
                               t_min, t_max, n_steps, prior_pars,
                               obs_data, obs_times, obs_weight, obs_var,
                               ode_flat, jac_flat=None,
                               mesh=None, axis_name="batch",
                               kalman_type="standard"):
    r"""
    :func:`rodeo_tpu.ops.pallas_fenrir.fenrir_fused_batch` with the lane
    axis sharded over a device mesh.  Returns ``(n_lane,)`` log-likelihood
    values, globally sharded.
    """
    from rodeo_tpu.ops import pallas_fenrir as pf
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)

    def local(th, x0, W, yobs, D, Om):
        return pf.fenrir_fused_batch(
            thetas=th, ode_weight=W, ode_inits=x0,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            prior_pars=prior_pars,
            obs_data=yobs, obs_times=obs_times, obs_weight=D, obs_var=Om,
            ode_flat=ode_flat, jac_flat=jac_flat,
            kalman_type=kalman_type)

    return _lane_sharded(local, mesh, axis_name, 1, 0)(
        thetas, ode_inits, ode_weight, obs_data, obs_weight, obs_var)


def sharded_dalton_fused_batch(thetas, ode_weight, ode_inits,
                               t_min, t_max, n_steps, prior_pars,
                               obs_data, obs_times, obs_weight, obs_var,
                               ode_flat, jac_flat=None,
                               mesh=None, axis_name="batch",
                               kalman_type="standard"):
    r"""
    :func:`rodeo_tpu.ops.pallas_dalton.dalton_fused_batch` with the lane
    axis sharded over a device mesh.  Returns ``(n_lane,)`` log-likelihood
    values, globally sharded.
    """
    from rodeo_tpu.ops import pallas_dalton as pd
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)

    def local(th, x0, W, yobs, D, Om):
        return pd.dalton_fused_batch(
            thetas=th, ode_weight=W, ode_inits=x0,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            prior_pars=prior_pars,
            obs_data=yobs, obs_times=obs_times, obs_weight=D, obs_var=Om,
            ode_flat=ode_flat, jac_flat=jac_flat,
            kalman_type=kalman_type)

    return _lane_sharded(local, mesh, axis_name, 1, 0)(
        thetas, ode_inits, ode_weight, obs_data, obs_weight, obs_var)


def sharded_daltonng_fused_batch(thetas, ode_weight, ode_inits,
                                 t_min, t_max, n_steps, prior_pars,
                                 obs_data, obs_times, obs_comp_flat,
                                 obs_dims, ode_flat, jac_flat=None,
                                 mesh=None, axis_name="batch",
                                 kalman_type="standard"):
    r"""
    :func:`rodeo_tpu.ops.pallas_daltonng.daltonng_fused_batch` with the
    lane axis sharded over a device mesh.  Returns ``(n_lane,)``
    log-likelihood values, globally sharded.
    """
    from rodeo_tpu.ops import pallas_daltonng as png
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)

    def local(th, x0, W, yobs):
        return png.daltonng_fused_batch(
            thetas=th, ode_weight=W, ode_inits=x0,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            prior_pars=prior_pars,
            obs_data=yobs, obs_times=obs_times,
            obs_comp_flat=obs_comp_flat, obs_dims=obs_dims,
            ode_flat=ode_flat, jac_flat=jac_flat,
            kalman_type=kalman_type)

    return _lane_sharded(local, mesh, axis_name, 1, 0)(
        thetas, ode_inits, ode_weight, obs_data)


def sharded_basic_fused_batch(thetas, ode_weight, ode_inits,
                              t_min, t_max, n_steps, prior_pars,
                              obs_data, obs_times, obs_loglik,
                              ode_flat, jac_flat=None,
                              mesh=None, axis_name="batch",
                              kalman_type="standard", **params):
    r"""
    :func:`rodeo_tpu.ops.pallas_kalman.basic_fused_batch` with the lane
    axis sharded over a device mesh.  Returns ``(loglik (n_lane,),
    mean (n_steps+1, n_block, q, n_lane))``, globally sharded.
    """
    from rodeo_tpu.ops import pallas_kalman as pk
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)

    def local(th, x0, W, yobs):
        return pk.basic_fused_batch(
            thetas=th, ode_weight=W, ode_inits=x0,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            prior_pars=prior_pars,
            obs_data=yobs, obs_times=obs_times, obs_loglik=obs_loglik,
            ode_flat=ode_flat, jac_flat=jac_flat,
            kalman_type=kalman_type, **params)

    def wrapped(thetas, ode_inits, *reps):
        in_specs = (P(axis_name), P(axis_name)) + (P(),) * len(reps)
        out_specs = (P(axis_name), P(None, None, None, axis_name))
        return shard_map(
            local, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )(thetas, ode_inits, *reps)

    return wrapped(thetas, ode_inits, ode_weight, obs_data)


def sharded_fenrir_fused_batch_grad(thetas, ode_weight, ode_inits,
                                    t_min, t_max, n_steps, prior_pars,
                                    obs_data, obs_times, obs_weight,
                                    obs_var, ode_flat, jac_flat=None,
                                    mesh=None, axis_name="batch"):
    r"""
    :func:`rodeo_tpu.ops.pallas_fenrir.fenrir_fused_batch_grad` with the
    lane axis sharded over a device mesh (gradient-MCMC / MAP fleets:
    lane groups per chip, zero collectives).  Returns ``(loglik
    (n_lane,), grad (n_lane, n_theta))``, globally sharded on lanes.
    """
    from rodeo_tpu.ops import pallas_fenrir as pf
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)

    def local(th, x0, W, yobs, D, Om):
        return pf.fenrir_fused_batch_grad(
            thetas=th, ode_weight=W, ode_inits=x0,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            prior_pars=prior_pars,
            obs_data=yobs, obs_times=obs_times, obs_weight=D, obs_var=Om,
            ode_flat=ode_flat, jac_flat=jac_flat)

    return shard_map(
        local, mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(), P(), P(), P()),
        out_specs=(P(axis_name), P(axis_name)),
        check_vma=False,
    )(thetas, ode_inits, ode_weight, obs_data, obs_weight, obs_var)


def sharded_dalton_fused_batch_grad(thetas, ode_weight, ode_inits,
                                    t_min, t_max, n_steps, prior_pars,
                                    obs_data, obs_times, obs_weight,
                                    obs_var, ode_flat, jac_flat=None,
                                    mesh=None, axis_name="batch"):
    r"""
    :func:`rodeo_tpu.ops.pallas_dalton.dalton_fused_batch_grad` with the
    lane axis sharded over a device mesh.  Returns ``(loglik (n_lane,),
    grad (n_lane, n_theta))``, globally sharded on lanes.
    """
    from rodeo_tpu.ops import pallas_dalton as pd
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)

    def local(th, x0, W, yobs, D, Om):
        return pd.dalton_fused_batch_grad(
            thetas=th, ode_weight=W, ode_inits=x0,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            prior_pars=prior_pars,
            obs_data=yobs, obs_times=obs_times, obs_weight=D, obs_var=Om,
            ode_flat=ode_flat, jac_flat=jac_flat)

    return shard_map(
        local, mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(), P(), P(), P()),
        out_specs=(P(axis_name), P(axis_name)),
        check_vma=False,
    )(thetas, ode_inits, ode_weight, obs_data, obs_weight, obs_var)


def sharded_basic_fused_batch_grad(thetas, ode_weight, ode_inits,
                                   t_min, t_max, n_steps, prior_pars,
                                   obs_data, obs_times, obs_loglik,
                                   ode_flat, jac_flat=None,
                                   mesh=None, axis_name="batch", **params):
    r"""
    :func:`rodeo_tpu.ops.pallas_kalman.basic_fused_batch_grad` with the
    lane axis sharded over a device mesh.  Returns ``(loglik (n_lane,),
    grad (n_lane, n_theta), mean (n_steps+1, n_block, q, n_lane))``,
    globally sharded on lanes.
    """
    from rodeo_tpu.ops import pallas_kalman as pk
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)

    def local(th, x0, W, yobs):
        return pk.basic_fused_batch_grad(
            thetas=th, ode_weight=W, ode_inits=x0,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            prior_pars=prior_pars,
            obs_data=yobs, obs_times=obs_times, obs_loglik=obs_loglik,
            ode_flat=ode_flat, jac_flat=jac_flat, **params)

    return shard_map(
        local, mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(), P()),
        out_specs=(P(axis_name), P(axis_name),
                   P(None, None, None, axis_name)),
        check_vma=False,
    )(thetas, ode_inits, ode_weight, obs_data)


def sharded_solve_sim_fused_batch(key, thetas, ode_weight, ode_inits,
                                  t_min, t_max, n_steps, prior_pars,
                                  ode_flat, jac_flat=None,
                                  mesh=None, axis_name="batch",
                                  kalman_type="standard"):
    r"""
    :func:`rodeo_tpu.ops.pallas_sim.solve_sim_fused_batch` with the lane
    axis sharded over a device mesh; each chip draws its lane group with
    an independent key (folded from the mesh position).  Returns
    ``(n_steps+1, n_block, q, n_lane)`` paths, globally sharded on the
    lane axis.
    """
    from rodeo_tpu.ops import pallas_sim as ps
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)

    def local(th, x0, W):
        k = jax.random.fold_in(key, jax.lax.axis_index(axis_name))
        return ps.solve_sim_fused_batch(
            key=k, thetas=th, ode_weight=W, ode_inits=x0,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            prior_pars=prior_pars, ode_flat=ode_flat, jac_flat=jac_flat,
            kalman_type=kalman_type)

    return _lane_sharded(local, mesh, axis_name, 1, 3)(
        thetas, ode_inits, ode_weight)


def sharded_magi_fused_batch(ode_data_subsets, ode_expand, n_active,
                             prior_pars, dt, sig2_lanes=None,
                             mesh=None, axis_name="batch", **params):
    r"""
    :func:`rodeo_tpu.ops.pallas_magi.magi_fused_batch` with the lane axis
    (candidate paths / MCMC chains over the subset state) sharded over a
    device mesh.  Returns ``(n_lane,)`` log-densities, globally sharded.
    """
    from rodeo_tpu.ops import pallas_magi as pm
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)

    def local(subsets, sig2):
        return pm.magi_fused_batch(
            subsets, ode_expand, n_active, prior_pars, dt,
            sig2_lanes=sig2, **params)

    if sig2_lanes is None:
        sig2_lanes = jnp.ones(ode_data_subsets.shape[0], jnp.float32)
    return shard_map(
        local, mesh=mesh, in_specs=(P(axis_name), P(axis_name)),
        out_specs=P(axis_name), check_vma=False,
    )(ode_data_subsets, jnp.asarray(sig2_lanes, jnp.float32))


def sharded_magi_fused_batch_grad(ode_data_subsets, ode_expand, n_active,
                                  prior_pars, dt, theta_lanes=None,
                                  sig2_lanes=None,
                                  mesh=None, axis_name="batch", **params):
    r"""
    :func:`rodeo_tpu.ops.pallas_magi.magi_fused_batch_grad` with the lane
    axis sharded over a device mesh — gradient MAP/MALA fleets over the
    MAGI path state, lane groups per chip, zero collectives.  Returns
    ``(ld (n_lane,), grad_subsets)`` (+ ``grad_theta`` when
    ``theta_lanes`` is given), globally sharded on the lane axis.
    """
    from rodeo_tpu.ops import pallas_magi as pm
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)
    if sig2_lanes is None:
        sig2_lanes = jnp.ones(ode_data_subsets.shape[0], jnp.float32)
    sig2_lanes = jnp.asarray(sig2_lanes, jnp.float32)

    if theta_lanes is None:
        def local(subsets, sig2):
            return pm.magi_fused_batch_grad(
                subsets, ode_expand, n_active, prior_pars, dt,
                sig2_lanes=sig2,
                **params)
        return shard_map(
            local, mesh=mesh, in_specs=(P(axis_name), P(axis_name)),
            out_specs=(P(axis_name), P(axis_name)), check_vma=False,
        )(ode_data_subsets, sig2_lanes)

    def local(subsets, th, sig2):
        return pm.magi_fused_batch_grad(
            subsets, ode_expand, n_active, prior_pars, dt,
            theta_lanes=th, sig2_lanes=sig2, **params)
    return shard_map(
        local, mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name)),
        out_specs=(P(axis_name), P(axis_name), P(axis_name)),
        check_vma=False,
    )(ode_data_subsets, theta_lanes, sig2_lanes)


def run_chains_fused_sharded(loglik_fn, init_positions, key, n_samples,
                             rw_scale, ode_weight, ode_init,
                             t_min, t_max, n_steps, prior_pars,
                             ode_flat, jac_flat=None,
                             position_to_init=None,
                             mesh=None, axis_name="chain"):
    r"""
    :func:`rodeo_tpu.parallel.chains.run_chains_fused` with the chain axis
    sharded over a device mesh: every chip advances its chain group in
    lockstep through the fused sampler, zero cross-chip collectives.  Each
    chip's PRNG stream is folded from its mesh position, so results match
    a single-chip run distributionally (not bitwise).

    Same arguments/returns as ``run_chains_fused`` plus ``mesh`` /
    ``axis_name``; ``n_lane`` must divide the mesh size.
    """
    from rodeo_tpu.parallel.chains import run_chains_fused
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)

    def local(init_pos, W, x0):
        k = jax.random.fold_in(key, jax.lax.axis_index(axis_name))
        return run_chains_fused(
            loglik_fn, init_pos, k, n_samples, rw_scale,
            ode_weight=W, ode_init=x0, t_min=t_min, t_max=t_max,
            n_steps=n_steps, prior_pars=prior_pars, ode_flat=ode_flat,
            jac_flat=jac_flat, position_to_init=position_to_init)

    return shard_map(
        local, mesh=mesh,
        in_specs=(P(axis_name), P(), P()),
        out_specs=(P(None, axis_name), P(axis_name), P(axis_name)),
        check_vma=False,
    )(init_positions, ode_weight, ode_init)
