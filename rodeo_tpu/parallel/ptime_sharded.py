r"""
Multi-chip parallel-in-time Kalman filtering/smoothing: the time axis
sharded over a device mesh.

:mod:`rodeo_tpu.ops.ptime` runs the associative-scan Kalman filter and RTS
smoother in :math:`O(\log N)` depth on ONE chip.  This module scales the
same recursions over the *time* axis of a ``jax.sharding.Mesh`` — the one
axis of this problem family that is not embarrassingly parallel (the
reference advances it strictly sequentially,
``/root/reference/src/rodeo/solve.py:112,291``).  The decomposition is the
classic three-phase distributed prefix scan, specialized to the
conditional-Gaussian element algebra of Särkkä & García-Fernández 2021:

1. **local scan** — each chip runs ``jax.lax.associative_scan`` over its own
   contiguous time chunk (:math:`O(\log(N/P))` depth, zero communication);
2. **chunk-total exchange** — each chip's *total* element (the combine of
   its whole chunk) is ``all_gather``-ed over NVLink: :math:`P` tiny
   :math:`(n_{block}, q, q)` tensors, one collective;
3. **prefix fold + local fix-up** — every chip combines the gathered totals
   into its *exclusive* incoming prefix (a log-depth scan over :math:`P`
   replicated elements) and applies it to its local results with ONE
   broadcasted element combine.

Total sequential depth :math:`O(\log(N/P) + \log P) = O(\log N)` with the
:math:`N`-proportional work split :math:`P` ways, and exactly one
``all_gather`` of per-chip scalars-scale data per pass — the collective
rides NVLink between the cards of one host.  The same structure runs the
smoother as a suffix
scan (``reverse=True``).

The combines are algebraically identical to the single-chip path, so
results match :func:`rodeo_tpu.ops.ptime.parallel_filter` /
:func:`parallel_smooth_mv` up to floating-point reordering.

Entry points:

- :func:`sharded_parallel_filter` — affine-model Kalman filter, same
  contract as :func:`rodeo_tpu.ops.ptime.parallel_filter`.
- :func:`sharded_parallel_smooth_mv` — RTS smoother over stored forward
  outputs, same contract as :func:`parallel_smooth_mv`.
- :func:`sharded_solve_mv_iterated` — the fully parallel-in-time iterated
  ODE solver of :func:`rodeo_tpu.ops.ptime.solve_mv_iterated` (global
  mode) with every sweep's filter and the final smoother time-sharded;
  the per-step ODE relinearization is elementwise over time and therefore
  shards for free.
"""
import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

try:
    from jax import shard_map                      # jax >= 0.8
except ImportError:                                # pragma: no cover
    from jax.experimental.shard_map import shard_map

from rodeo_tpu.utils import mtt, mvdot, quadform
from rodeo_tpu.ops.linalg import full_matmul_precision
from rodeo_tpu.ops.ptime import (
    _filter_combine, _filter_elements, _filter_elements_tv,
    _smooth_combine, _smooth_elements, _psd_sqrt, _compose_prior)
from rodeo_tpu.parallel.mesh import make_mesh

__all__ = [
    "sharded_parallel_filter",
    "sharded_parallel_filter_tv",
    "sharded_parallel_smooth_mv",
    "sharded_solve_mv_iterated",
]


def _check_mesh(mesh, axis_name, n_steps):
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)
    n_dev = mesh.shape[axis_name]
    if n_steps % n_dev:
        raise ValueError(
            f"n_steps ({n_steps}) must be divisible by the size of mesh "
            f"axis {axis_name!r} ({n_dev})")
    return mesh


def _axis_exclusive(totals, identity, combine, axis_name, reverse=False):
    """
    Exclusive cross-chip prefix (or suffix, ``reverse=True``) of per-chip
    total elements.

    ``totals`` is this chip's total element (a tuple of arrays).  Gathers
    all chips' totals (ONE ``all_gather`` of tiny tensors over NVLink), scans
    them with ``combine`` (log-depth, replicated), shifts by one inserting
    ``identity`` at the open end, and returns this chip's entry.
    """
    gathered = jax.lax.all_gather(totals, axis_name)   # leading axis = P
    scanned = jax.lax.associative_scan(combine, gathered, reverse=reverse)
    if reverse:
        # exclusive suffix: chip j gets combine(totals[j+1..P-1])
        padded = jax.tree.map(
            lambda s, i: jnp.concatenate([s[1:], i[None]]),
            scanned, identity)
    else:
        # exclusive prefix: chip j gets combine(totals[0..j-1])
        padded = jax.tree.map(
            lambda s, i: jnp.concatenate([i[None], s[:-1]]),
            scanned, identity)
    idx = jax.lax.axis_index(axis_name)
    return jax.tree.map(
        lambda x: jax.lax.dynamic_index_in_dim(x, idx, 0, keepdims=False),
        padded)


def _filter_identity(like):
    """Two-sided identity of ``_filter_combine``: (I, 0, 0, 0, 0)."""
    A, b, C, eta, J = like
    eye = jnp.broadcast_to(jnp.eye(A.shape[-1], dtype=A.dtype), A.shape)
    return (eye, jnp.zeros_like(b), jnp.zeros_like(C),
            jnp.zeros_like(eta), jnp.zeros_like(J))


def _smooth_identity(like):
    """Two-sided identity of ``_smooth_combine``: (I, 0, 0)."""
    E, g, L = like
    eye = jnp.broadcast_to(jnp.eye(E.shape[-1], dtype=E.dtype), E.shape)
    return (eye, jnp.zeros_like(g), jnp.zeros_like(L))


def _filter_local(axis_name, mean_init, var_init, prior_weight, prior_var,
                  A, b, C, eta, J):
    """Per-chip body of the sharded filter (runs inside ``shard_map``)."""
    loc = jax.lax.associative_scan(_filter_combine, (A, b, C, eta, J))
    totals = jax.tree.map(lambda x: x[-1], loc)
    prefix = _axis_exclusive(
        totals, _filter_identity(totals), _filter_combine, axis_name)
    # fix up the local prefixes with the incoming cross-chip prefix: one
    # broadcasted combine.  Lift the prefix leaves (nb, ...) to
    # (1, nb, ...) so every leaf has the same rank as the local results
    # (Nloc, nb, ...) — solve_small distinguishes vector from matrix
    # right-hand sides by relative rank, so mixed ranks mis-dispatch.
    prefix_b = jax.tree.map(lambda x: x[None], prefix)
    _, mean_filt, var_filt, _, _ = _filter_combine(prefix_b, loc)
    # the exclusive prefix element's (b, C) IS the filtered state at this
    # chip's left boundary — except on chip 0, where it is the identity's
    # zeros and the true boundary state is the initial distribution
    idx = jax.lax.axis_index(axis_name)
    m_edge = jnp.where(idx == 0, mean_init, prefix[1])
    v_edge = jnp.where(idx == 0, var_init, prefix[2])
    mean_prev = jnp.concatenate([m_edge[None], mean_filt[:-1]])
    var_prev = jnp.concatenate([v_edge[None], var_filt[:-1]])
    mean_pred = mvdot(prior_weight, mean_prev)
    var_pred = quadform(prior_weight, var_prev) + prior_var
    return mean_filt, var_filt, mean_pred, var_pred


@full_matmul_precision
def sharded_parallel_filter(mean_init, var_init,
                            prior_weight, prior_var,
                            wgt_meas, mean_meas, var_meas, x_meas,
                            mesh=None, axis_name="time"):
    r"""
    Time-sharded exact parallel Kalman filter for an affine measurement
    model: :func:`rodeo_tpu.ops.ptime.parallel_filter` with the time axis
    split over a device mesh (local associative scans + one ``all_gather``
    of per-chip total elements over NVLink).

    Args: as :func:`rodeo_tpu.ops.ptime.parallel_filter`, plus

        mesh (jax.sharding.Mesh | None): 1-D device mesh (default: all
            devices).  ``n_steps`` must be divisible by its size.
        axis_name (str): Mesh axis to shard the time axis over.

    Returns:
        (dict): ``state_filt`` / ``state_pred`` stacked
        ``(n_steps+1, n_block, ...)`` pytrees, identical (up to fp
        reordering) to the single-chip parallel filter and to the
        sequential scan.
    """
    n_steps = wgt_meas.shape[0]
    mesh = _check_mesh(mesh, axis_name, n_steps)
    elems = _filter_elements(
        mean_init, var_init, prior_weight, prior_var,
        wgt_meas, mean_meas, var_meas, x_meas)
    local = functools.partial(_filter_local, axis_name)
    t_spec = P(axis_name)
    mean_filt, var_filt, mean_pred, var_pred = shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(), P()) + (t_spec,) * 5,
        out_specs=(t_spec,) * 4,
        check_vma=False,
    )(mean_init, var_init, prior_weight, prior_var, *elems)
    out_filt = (
        jnp.concatenate([mean_init[None], mean_filt]),
        jnp.concatenate([var_init[None], var_filt]),
    )
    out_pred = (
        jnp.concatenate([mean_init[None], mean_pred]),
        jnp.concatenate([var_init[None], var_pred]),
    )
    return {"state_filt": out_filt, "state_pred": out_pred}


def _filter_local_tv(axis_name, mean_init, var_init,
                     wgt_state, mean_state, var_state,
                     A, b, C, eta, J):
    """Per-chip body of the time-varying sharded filter: as
    :func:`_filter_local`, but predictions use this chip's per-step
    transition shards."""
    loc = jax.lax.associative_scan(_filter_combine, (A, b, C, eta, J))
    totals = jax.tree.map(lambda x: x[-1], loc)
    prefix = _axis_exclusive(
        totals, _filter_identity(totals), _filter_combine, axis_name)
    prefix_b = jax.tree.map(lambda x: x[None], prefix)
    _, mean_filt, var_filt, _, _ = _filter_combine(prefix_b, loc)
    idx = jax.lax.axis_index(axis_name)
    m_edge = jnp.where(idx == 0, mean_init, prefix[1])
    v_edge = jnp.where(idx == 0, var_init, prefix[2])
    mean_prev = jnp.concatenate([m_edge[None], mean_filt[:-1]])
    var_prev = jnp.concatenate([v_edge[None], var_filt[:-1]])
    mean_pred = mvdot(wgt_state, mean_prev) + mean_state
    var_pred = quadform(wgt_state, var_prev) + var_state
    return mean_filt, var_filt, mean_pred, var_pred


@full_matmul_precision
def sharded_parallel_filter_tv(mean_init, var_init,
                               wgt_state, mean_state, var_state,
                               wgt_meas, mean_meas, var_meas, x_meas,
                               mesh=None, axis_name="time"):
    r"""
    Time-sharded exact parallel Kalman filter for a fully *time-varying*
    affine state-space model: :func:`rodeo_tpu.ops.ptime.parallel_filter_tv`
    with the time axis split over a device mesh (same three-phase
    distributed prefix scan as :func:`sharded_parallel_filter`).  This is
    the multi-chip engine for linear conditional chains such as the
    fenrir backward pass, whose per-step transitions come from
    ``smooth_cond`` (elementwise over time — they shard for free).

    Args: as :func:`rodeo_tpu.ops.ptime.parallel_filter_tv`, plus
    ``mesh`` / ``axis_name`` as in :func:`sharded_parallel_filter`.

    Returns:
        (dict): ``state_filt`` / ``state_pred`` stacked
        ``(n_steps+1, n_block, ...)`` pytrees, identical (up to fp
        reordering) to the single-chip variant.
    """
    n_steps = wgt_meas.shape[0]
    mesh = _check_mesh(mesh, axis_name, n_steps)
    elems = _filter_elements_tv(
        mean_init, var_init, wgt_state, mean_state, var_state,
        wgt_meas, mean_meas, var_meas, x_meas)
    local = functools.partial(_filter_local_tv, axis_name)
    t_spec = P(axis_name)
    mean_filt, var_filt, mean_pred, var_pred = shard_map(
        local, mesh=mesh,
        in_specs=(P(), P()) + (t_spec,) * 8,
        out_specs=(t_spec,) * 4,
        check_vma=False,
    )(mean_init, var_init, wgt_state, mean_state, var_state, *elems)
    return {
        "state_filt": (
            jnp.concatenate([mean_init[None], mean_filt]),
            jnp.concatenate([var_init[None], var_filt]),
        ),
        "state_pred": (
            jnp.concatenate([mean_init[None], mean_pred]),
            jnp.concatenate([var_init[None], var_pred]),
        ),
    }


def _smooth_local(axis_name, E, g, L):
    """Per-chip body of the sharded smoother (suffix scan)."""
    comb = lambda a, b: _smooth_combine(b, a)   # noqa: E731 — see ptime.py
    loc = jax.lax.associative_scan(comb, (E, g, L), reverse=True)
    totals = jax.tree.map(lambda x: x[0], loc)
    suffix = _axis_exclusive(
        totals, _smooth_identity(totals), comb, axis_name, reverse=True)
    # local element at k covers [k .. chunk_end]; the incoming suffix
    # covers (chunk_end .. N] — combine earlier-first.  Rank-lift the
    # suffix leaves so broadcasting matches the local (Nloc, nb, ...).
    suffix_b = jax.tree.map(lambda x: x[None], suffix)
    _, mean_smooth, var_smooth = _smooth_combine(loc, suffix_b)
    return mean_smooth, var_smooth


@full_matmul_precision
def sharded_parallel_smooth_mv(ode_init,
                               mean_state_filt, var_state_filt,
                               mean_state_pred, var_state_pred,
                               prior_weight, prior_var,
                               kalman_type="standard",
                               mesh=None, axis_name="time"):
    r"""
    Time-sharded exact parallel RTS smoother:
    :func:`rodeo_tpu.ops.ptime.parallel_smooth_mv` with the suffix
    associative scan split over a device mesh.

    Args: as :func:`rodeo_tpu.ops.ptime.parallel_smooth_mv`, plus ``mesh``
    / ``axis_name`` as in :func:`sharded_parallel_filter`.

    Returns:
        (tuple): ``mean_state_smooth``, ``var_state_smooth`` of shapes
        ``(n_steps+1, n_block, s[, s])``.
    """
    sqrt_mode = kalman_type == "square-root"
    if sqrt_mode:
        var_state_filt = var_state_filt @ mtt(var_state_filt)
        var_state_pred = var_state_pred @ mtt(var_state_pred)
    elif kalman_type != "standard":
        raise NotImplementedError(f"unknown kalman_type {kalman_type!r}")

    n_steps = mean_state_filt.shape[0] - 1
    mesh = _check_mesh(mesh, axis_name, n_steps)
    E, g, L = _smooth_elements(
        mean_state_filt, var_state_filt,
        mean_state_pred, var_state_pred, prior_weight)
    local = functools.partial(_smooth_local, axis_name)
    t_spec = P(axis_name)
    mean_smooth, var_smooth = shard_map(
        local, mesh=mesh,
        in_specs=(t_spec,) * 3,
        out_specs=(t_spec,) * 2,
        check_vma=False,
    )(E, g, L)
    zero_var = jnp.zeros_like(var_state_filt[:1])
    mean_out = jnp.concatenate([ode_init[None], mean_smooth])
    var_out = jnp.concatenate([zero_var, var_smooth])
    if sqrt_mode:
        var_out = _psd_sqrt(var_out)
    return mean_out, var_out


@full_matmul_precision
def sharded_solve_mv_iterated(key, ode_fun, ode_weight, ode_init,
                              t_min, t_max, n_steps,
                              interrogate,
                              prior_pars,
                              n_iter=20, warm_start=True, n_coarse=64,
                              mesh=None, axis_name="time", **params):
    r"""
    Multi-chip fully parallel-in-time probabilistic ODE solve.

    The iterated global-relinearization solver of
    :func:`rodeo_tpu.ops.ptime.solve_mv_iterated` (global mode) with its
    time axis sharded over a device mesh: each sweep's ODE interrogation
    is elementwise over time (each chip linearizes its own chunk), the
    exact parallel filter runs via :func:`sharded_parallel_filter`, and
    the final smoother via :func:`sharded_parallel_smooth_mv`.  Per sweep
    the only cross-chip traffic is one ``all_gather`` of per-chip
    :math:`(n_{block}, q, q)`-sized total elements.

    Same caveats as the single-chip iterated solver: use a first-order
    interrogation (:func:`~rodeo_tpu.interrogate.interrogate_kramer`) and
    a dynamics-resolving warm start.  The sequential-window mode is
    inherently causal across windows and is not offered here.

    Args: as :func:`rodeo_tpu.ops.ptime.solve_mv_iterated` (minus the
    window options), plus ``mesh`` / ``axis_name``.

    Returns:
        (tuple): ``mean_state_smooth``, ``var_state_smooth`` — same
        contract as :func:`rodeo_tpu.solve.solve_mv`.
    """
    prior_weight, prior_var = prior_pars
    n_block, n_bmeas, n_bstate = ode_weight.shape
    dtype = ode_init.dtype
    var_init = jnp.zeros((n_block, n_bstate, n_bstate), dtype=dtype)
    mesh = _check_mesh(mesh, axis_name, n_steps)

    tgrid = t_min + (t_max - t_min) * (jnp.arange(n_steps) + 1) / n_steps
    if key is not None:
        keys = jax.random.split(key, num=n_steps)
    else:
        keys = jnp.zeros(n_steps)

    def interrogate_all(mean_pred, var_pred):
        def one(key_n, t, m, v):
            return interrogate(
                key=key_n, ode_fun=ode_fun, ode_weight=ode_weight, t=t,
                mean_state_pred=m, var_state_pred=v, **params)
        return jax.vmap(one)(keys, tgrid, mean_pred, var_pred)

    var_pred = jnp.broadcast_to(
        prior_var, (n_steps,) + prior_var.shape).astype(dtype)
    if warm_start:
        from rodeo_tpu.solve import solve_mv as _solve_mv_seq
        cf = max(1, -(-n_steps // n_coarse))        # coarse factor (ceil)
        n_c = n_steps // cf
        dt = (t_max - t_min) / n_steps
        coarse_prior = _compose_prior(prior_weight, prior_var, cf)
        mu_c, _ = _solve_mv_seq(
            key=key, ode_fun=ode_fun, ode_weight=ode_weight,
            ode_init=ode_init, t_min=t_min, t_max=t_min + n_c * cf * dt,
            n_steps=n_c, interrogate=interrogate, prior_pars=coarse_prior,
            **params)
        t_c = t_min + (jnp.arange(n_c + 1)) * cf * dt
        interp = jax.vmap(jax.vmap(
            lambda ys: jnp.interp(tgrid, t_c, ys),
            in_axes=-1, out_axes=-1), in_axes=1, out_axes=1)
        mean_pred = interp(mu_c)
    else:
        mean_pred = jnp.broadcast_to(
            ode_init, (n_steps,) + ode_init.shape).astype(dtype)
    x_meas = jnp.zeros((n_steps, n_block, n_bmeas), dtype=dtype)

    def run_filter(mean_pred, var_pred):
        wgt_meas, mean_meas, var_meas = interrogate_all(mean_pred, var_pred)
        return sharded_parallel_filter(
            mean_init=ode_init, var_init=var_init,
            prior_weight=prior_weight, prior_var=prior_var,
            wgt_meas=ode_weight + wgt_meas,
            mean_meas=mean_meas, var_meas=var_meas, x_meas=x_meas,
            mesh=mesh, axis_name=axis_name)

    def sweep(carry, _):
        out = run_filter(*carry)
        # same transient-recovery clamps as the single-chip iterated solver
        m_new = jnp.clip(
            jnp.nan_to_num(out["state_pred"][0][1:],
                           nan=0.0, posinf=1e12, neginf=-1e12),
            -1e12, 1e12)
        v_raw = out["state_pred"][1][1:]
        v_new = jnp.where(
            jnp.all(jnp.isfinite(v_raw), axis=(-1, -2), keepdims=True),
            v_raw, jnp.broadcast_to(prior_var, v_raw.shape))
        return (m_new, v_new), None

    # lax.scan over sweeps (NOT a Python loop): the sweep body contains a
    # shard_map'ed filter, and unrolling n_iter copies of it makes compile
    # time explode (observed ~10x at n_iter=40)
    (mean_pred, var_pred), _ = jax.lax.scan(
        sweep, (mean_pred, var_pred), None, length=n_iter)

    out = run_filter(mean_pred, var_pred)
    return sharded_parallel_smooth_mv(
        ode_init=ode_init,
        mean_state_filt=out["state_filt"][0],
        var_state_filt=out["state_filt"][1],
        mean_state_pred=out["state_pred"][0],
        var_state_pred=out["state_pred"][1],
        prior_weight=prior_weight, prior_var=prior_var,
        kalman_type="standard", mesh=mesh, axis_name=axis_name)
