r"""
Mesh-sharded large-state solves: model parallelism over the state axis.

The large-state regime (:mod:`rodeo_tpu.models.heat`-style dense blocks)
is the one place in this library where a *single* solve has enough
arithmetic to shard: every covariance step is :math:`O(n^3)` matmuls on
``(n, n)`` operands.  This module runs the stationary-gain solver
(:func:`rodeo_tpu.ops.stationary.solve_mv_stationary`) with the
**trailing state axis sharded over the mesh** — each device owns a
column slab of the covariance/gain matrices; GSPMD inserts the
all-gathers for the contracted operand of each matmul, and those ride
NVLink.  The small :math:`(n_{\text{bmeas}}, n_{\text{bmeas}})` innovation
Cholesky stays replicated (a distributed Cholesky would be latency-bound
at these sizes).

This is genuine model parallelism — one solve over many chips — as
opposed to the lane/chain data parallelism of
:mod:`rodeo_tpu.parallel.fused` and the time-axis sharding of
:mod:`rodeo_tpu.parallel.ptime_sharded`.  It pays once the per-device
slab is large, i.e. states of thousands of dimensions; below that
the replicated single-chip path is faster.  Values are independent of
the device count up to float reassociation in the collectives.
"""
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

from rodeo_tpu.ops.stationary import solve_mv_stationary

__all__ = ["sharded_solve_mv_stationary"]


def sharded_solve_mv_stationary(mesh, key, ode_fun, ode_weight, ode_init,
                                t_min, t_max, n_steps,
                                interrogate,
                                prior_pars,
                                n_deriv=None, n_warm=100, var_out="full",
                                axis_name=None, **params):
    r"""
    :func:`rodeo_tpu.ops.stationary.solve_mv_stationary` with the state
    axis sharded over ``mesh``'s first axis (``axis_name`` defaults to
    it).  The state dimension must divide by the mesh size.  Same return
    contract; the smoothed covariances (``var_out="full"``) come back
    sharded on their trailing axis, the means replicated.
    """
    if axis_name is None:
        axis_name = mesh.axis_names[0]
    n_dev = mesh.shape[axis_name]
    n_state = ode_init.shape[-1]
    if n_state % n_dev:
        raise ValueError(
            f"state dim {n_state} must divide by the mesh size {n_dev}")

    col = NamedSharding(mesh, PartitionSpec(None, None, axis_name))
    repl = NamedSharding(mesh, PartitionSpec())
    # column-slab placement of everything with a trailing state axis;
    # GSPMD propagates through the Riccati/mean/smoother scans from here
    wgt_sh = jax.device_put(ode_weight, col)
    prior_sh = (jax.device_put(prior_pars[0], col),
                jax.device_put(prior_pars[1], col))
    init_sh = jax.device_put(ode_init, repl)

    fn = jax.jit(
        lambda w, x0, pp: solve_mv_stationary(
            key=key, ode_fun=ode_fun, ode_weight=w, ode_init=x0,
            t_min=t_min, t_max=t_max, n_steps=n_steps,
            interrogate=interrogate, prior_pars=pp, n_deriv=n_deriv,
            n_warm=n_warm, var_out=var_out, **params))
    return fn(wgt_sh, init_sh, prior_sh)
