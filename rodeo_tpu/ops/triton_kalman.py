r"""
GPU kernels for the lane-batched forward filter and backward smoother:
Pallas through Triton.

Under ``lax.scan`` every one of the ``n_steps`` solver steps costs at
least one kernel launch plus loop bookkeeping, however few FLOPs it
holds.  These kernels instead run the **whole time loop inside one
Triton program**:

* lanes (independent solves) go across programs, :data:`LANE_TILE` lanes
  per program (a power of two: Triton tensors must have power-of-two
  shapes); loads and stores are masked on the lane axis, so a lane count
  the tile does not divide keeps the full tile;
* each block's columns are held as separate ``(tile,)`` vectors, so
  ``n_block = 3`` (Lorenz63) needs no padding, and the carry stays in
  registers for all steps;
* per-step outputs are stored lanes-last, one contiguous row per
  ``(column, block)``.

The step math is not duplicated: the kernels run the shared step
functions of :mod:`rodeo_tpu.ops.pallas_kalman` (``_filter_step``,
``_smoother_step``) block by block, exactly as
:func:`rodeo_tpu.ops.scan.scan_steps` runs them on whole tiles.  The
model's ``*_flat`` callables see all blocks at once through
:func:`rodeo_tpu.ops.flat_rows.rows_call`, which evaluates the callable's
jaxpr on per-block rows (Triton lowers neither row slices nor general
concatenation).

:func:`rodeo_tpu.ops.scan.kernel_route` selects these kernels on a GPU
backend; the tests run them in interpret mode on the CPU.
"""
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from rodeo_tpu.ops.flat_rows import rows_call
from rodeo_tpu.ops.pallas_kalman import _filter_step, _smoother_step

__all__ = ["filter_batch", "smoother_batch", "LANE_TILE", "NUM_WARPS"]

#: Lanes per Triton program (fewer when ``n_lane`` is smaller: the least
#: power of two holding it).  Chosen by measurement on the card; see
#: PERF.md.
LANE_TILE = 32
#: Warps per Triton program.
NUM_WARPS = 1


def _lane_tile(n_lane):
    return min(LANE_TILE, pl.next_power_of_2(n_lane))


def _lane_io(n_lane, tile):
    """``load(ref, *idx)`` / ``store(ref, idx, val)`` of one ``(tile,)``
    lane vector of a lane-blocked ref, for use inside a kernel, masked on
    the lanes past ``n_lane`` (masked-off lanes load zeros and compute
    values that are never stored).  Every program masks, even where the
    tile divides ``n_lane``: on the card the masked path measured as fast
    at 1 lane and 9% faster at 2048 lanes than plain ``ref[...]`` access
    (PERF.md)."""
    mask = pl.program_id(0) * tile + jnp.arange(tile) < n_lane

    def load(ref, *idx):
        return plgpu.load(ref.at[idx], mask=mask, other=0.0)

    def store(ref, idx, val):
        plgpu.store(ref.at[idx], val, mask=mask)
    return load, store


# --- kernels -------------------------------------------------------------------


def _call(kernel, out_shape, in_specs, out_specs, n_programs, name,
          interpret, args):
    return pl.pallas_call(
        kernel, out_shape=out_shape, grid=(n_programs,),
        in_specs=in_specs, out_specs=out_specs, name=name,
        backend="triton", interpret=interpret,
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1),
    )(*args)


def _whole(shape):
    return pl.BlockSpec(shape, lambda i: (0,) * len(shape))


def _lanes(shape, tile):
    return pl.BlockSpec(tuple(shape[:-1]) + (tile,),
                        lambda i: (0,) * (len(shape) - 1) + (i,))


def filter_batch(ode_flat, jac_flat, mode, emit, n_steps, q_const,
                 prior_weight, R_packed, W, x0_lanes, theta_lanes, tgrid,
                 t_vec, eps, interpret=False):
    """Forward filter kernel; same contract and outputs as
    :func:`rodeo_tpu.ops.pallas_kalman.fused_filter_batch` (all inputs
    float32, ``R_packed`` ``(n_block, n_tri)``, ``W`` ``(n_block, q)``,
    ``q_const`` the trace-time transition or ``None``)."""
    q, n_block, n_lane = x0_lanes.shape
    n_tri = R_packed.shape[1]
    n_theta = theta_lanes.shape[0]
    tile = _lane_tile(n_lane)
    has_eps = mode == "chkrebtii"
    if emit == "gains":
        widths = (q * q, q, n_tri)
    else:
        widths = (q, n_tri, q, n_tri)

    def kernel(*refs):
        it = iter(refs)
        w_ref, r_ref, tv_ref, t_ref, x0_ref, th_ref = (
            next(it) for _ in range(6))
        qm_ref = next(it) if q_const is None else None
        eps_ref = next(it) if has_eps else None
        out_refs = [next(it) for _ in widths]
        load, store = _lane_io(n_lane, tile)
        tv = [tv_ref[j] for j in range(q)]
        th_rows = [load(th_ref, i) for i in range(n_theta)]
        halves = []
        for b in range(n_block):
            Qm = q_const if q_const is not None else \
                [[qm_ref[b, i * q + j] for j in range(q)] for i in range(q)]
            halves.append(_filter_step(
                mode, emit, Qm, [r_ref[b, k] for k in range(n_tri)],
                [w_ref[b, j] for j in range(q)], tv))
        zero = jnp.zeros((tile,), jnp.float32)
        carry0 = [([load(x0_ref, j, b) for j in range(q)], [zero] * n_tri)
                  for b in range(n_block)]

        def body(t, carry):
            t_n = t_ref[t]
            preds, xs = [], []
            for b, (predict, _) in enumerate(halves):
                eps_b = [load(eps_ref, t, j, b) for j in range(q)] \
                    if has_eps else None
                pred, x = predict(carry[b], eps_b)
                preds.append(pred)
                xs.append(x)
            x_rows = [[xs[b][j] for b in range(n_block)] for j in range(q)]
            f0 = rows_call(ode_flat, x_rows, th_rows, t_n)
            jd = rows_call(jac_flat, x_rows, th_rows, t_n) \
                if mode == "kramer" else [None] * q
            new = []
            for b, (_, update) in enumerate(halves):
                c, outs = update(carry[b], preds[b], xs[b], f0[b],
                                 [None if col is None else col[b]
                                  for col in jd])
                for o_ref, cols in zip(out_refs, outs):
                    for k, col in enumerate(cols):
                        store(o_ref, (t, k, b),
                              jnp.broadcast_to(col, (tile,)))
                new.append(c)
            return new

        final = jax.lax.fori_loop(0, n_steps, body, carry0)
        if emit == "gains":
            m_ref, p_ref = next(it), next(it)
            for b in range(n_block):
                for j in range(q):
                    store(m_ref, (j, b), final[b][0][j])
                for k in range(n_tri):
                    store(p_ref, (k, b), final[b][1][k])

    args = [W, R_packed, t_vec, tgrid, x0_lanes, theta_lanes]
    in_specs = [_whole(W.shape), _whole(R_packed.shape), _whole((q,)),
                _whole((n_steps,)), _lanes(x0_lanes.shape, tile),
                _lanes(theta_lanes.shape, tile)]
    if q_const is None:
        args.append(prior_weight.reshape(n_block, q * q))
        in_specs.append(_whole((n_block, q * q)))
    if has_eps:
        args.append(eps)
        in_specs.append(_lanes(eps.shape, tile))
    out_shape = [jax.ShapeDtypeStruct((n_steps, d, n_block, n_lane),
                                      jnp.float32) for d in widths]
    if emit == "gains":
        out_shape += [jax.ShapeDtypeStruct((q, n_block, n_lane), jnp.float32),
                      jax.ShapeDtypeStruct((n_tri, n_block, n_lane),
                                           jnp.float32)]
    out_specs = [_lanes(o.shape, tile) for o in out_shape]
    return tuple(_call(kernel, out_shape, in_specs, out_specs,
                       pl.cdiv(n_lane, tile), f"rodeo_filter_{mode}_{emit}",
                       interpret, args))


def smoother_batch(g_k, G_k, L_k, mN, pN, interpret=False):
    """Backward smoother kernel; same contract and outputs as
    :func:`rodeo_tpu.ops.pallas_kalman.smoother_recursion_batch`."""
    n_len, q, n_block, n_lane = g_k.shape
    n_tri = L_k.shape[1]
    tile = _lane_tile(n_lane)
    step = _smoother_step(q)

    def kernel(g_ref, G_ref, L_ref, mN_ref, pN_ref, ms_ref, ps_ref):
        load, store = _lane_io(n_lane, tile)
        carry0 = [([load(mN_ref, j, b) for j in range(q)],
                   [load(pN_ref, k, b) for k in range(n_tri)])
                  for b in range(n_block)]

        def body(k, carry):
            r = n_len - 1 - k
            new = []
            for b in range(n_block):
                x_t = ([load(g_ref, r, i, b) for i in range(q)],
                       [load(G_ref, r, i, b) for i in range(q * q)],
                       [load(L_ref, r, i, b) for i in range(n_tri)])
                c, (m_out, p_out) = step(carry[b], x_t)
                for j in range(q):
                    store(ms_ref, (r, j, b), m_out[j])
                for kk in range(n_tri):
                    store(ps_ref, (r, kk, b), p_out[kk])
                new.append(c)
            return new

        jax.lax.fori_loop(0, n_len, body, carry0)

    args = [g_k, G_k, L_k, mN, pN]
    out_shape = [jax.ShapeDtypeStruct(g_k.shape, jnp.float32),
                 jax.ShapeDtypeStruct(L_k.shape, jnp.float32)]
    return tuple(_call(
        kernel, out_shape, [_lanes(a.shape, tile) for a in args],
        [_lanes(o.shape, tile) for o in out_shape], pl.cdiv(n_lane, tile),
        "rodeo_smoother", interpret, args))
