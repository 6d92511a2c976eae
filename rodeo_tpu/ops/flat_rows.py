r"""
The ``*_flat`` model contract, evaluated one block row at a time.

A flat callable ``fn(x_cols, th, t)`` (see :mod:`rodeo_tpu.models`) takes
``q`` state columns of shape ``(n_block, n_lane)``, per-lane parameters
``(n_theta, n_lane)`` and a scalar time, and returns an
``(n_block, n_lane)`` array (``ode_flat``) or a list of such columns and
``None`` (``jac_flat``).  Lanes are independent solves, so a flat
callable must never mix them.  It may use:

* row slices and single-row indexing (``x[0:1]``, ``x[1:]``, ``x[2]``);
* row concatenation and stacking (``jnp.concatenate(..., axis=0)``,
  ``jnp.stack``, ``jnp.vstack``) and broadcasting along rows;
* sums, maxima and minima over the row axis (``axis=0``);
* elementwise arithmetic and ``jnp`` elementwise functions (``exp``,
  ``where``, ``clip``, ...), ``jax.jvp`` of such code;
* closed-over scalars and ``(n, 1)`` per-row constants.

Matrix products, gathers, lane slices and reductions over lanes are
outside the contract.  The GPU kernels need it: Triton lowers neither
row slices nor general concatenation, so :func:`rows_call` evaluates the
callable's jaxpr with every 2-D value held as a list of ``(n_lane,)``
rows.  :func:`flat_call` checks a callable against the same rules on
every route, at trace time, so code that would fail on the GPU fails on
the CPU too.
"""
import functools

import jax
import jax.extend.core as jex_core
import jax.numpy as jnp
import numpy as np

__all__ = ["flat_call", "rows_call"]


class _Rows(list):
    """A ``(R, C)`` array held as ``R`` rows of shape ``(C,)``."""


_ELEMENTWISE = {
    "add", "sub", "mul", "div", "neg", "max", "min", "pow", "integer_pow",
    "exp", "exp2", "log", "log1p", "expm1", "sin", "cos", "tan", "tanh",
    "logistic", "sqrt", "rsqrt", "abs", "sign", "square", "select_n",
    "convert_element_type", "eq", "ne", "lt", "le", "gt", "ge", "and",
    "or", "not", "atan2", "copy", "copy_p", "clamp",
}
_ROW_REDUCE = {"reduce_sum": jax.lax.add, "reduce_max": jax.lax.max,
               "reduce_min": jax.lax.min}
_CALLS = ("jit", "pjit", "closed_call", "custom_jvp_call")


def _refuse(what):
    raise NotImplementedError(
        f"flat callables: {what} (see rodeo_tpu.ops.flat_rows)")


def _const(c):
    """A closed-over constant: a scalar, or per-row values ``(n, 1)``.
    Concrete values become NumPy scalars, which a kernel embeds as
    literals."""
    if jnp.ndim(c) == 2 and jnp.shape(c)[1] == 1:
        return _Rows(_const(c[i, 0]) for i in range(jnp.shape(c)[0]))
    if jnp.ndim(c) != 0:
        _refuse(f"a closed-over constant of shape {jnp.shape(c)} "
                "(scalars and (n, 1) columns only)")
    return c if isinstance(c, jax.core.Tracer) else np.asarray(c)[()]


def _eval_rows(jaxpr, consts, args):
    """Evaluate ``jaxpr`` with every 2-D value held as :class:`_Rows` and
    every 1-D value as one ``(n_lane,)`` row."""
    env = {}

    def read(v):
        return v.val if isinstance(v, jex_core.Literal) else env[v]

    for v, c in zip(jaxpr.constvars, consts):
        env[v] = _const(c)
    for v, a in zip(jaxpr.invars, args):
        env[v] = a
    for eqn in jaxpr.eqns:
        ins = [read(v) for v in eqn.invars]
        name, params = eqn.primitive.name, eqn.params
        out_aval = eqn.outvars[0].aval
        if name == "add_any":          # tangent accumulation of a jvp
            eqn = eqn.replace(primitive=jax.lax.add_p)
            name = "add"
        if name in _ELEMENTWISE:
            n = max((len(x) for x in ins if isinstance(x, _Rows)),
                    default=0)
            if n == 0:
                out = eqn.primitive.bind(*ins, **params)
            else:
                out = _Rows(eqn.primitive.bind(
                    *[(x[r] if len(x) > 1 else x[0])
                      if isinstance(x, _Rows) else x for x in ins],
                    **params) for r in range(n))
        elif name == "slice":
            (x,) = ins
            if not isinstance(x, _Rows):
                _refuse("slices along the lane axis")
            (r0, c0), (r1, c1) = params["start_indices"], \
                params["limit_indices"]
            if c0 != 0 or c1 != eqn.invars[0].aval.shape[1]:
                _refuse("slices along the lane axis")
            stride = (params["strides"] or (1, 1))[0]
            out = _Rows(x[r0:r1:stride])
        elif name == "concatenate":
            if params["dimension"] != 0 or \
                    not all(isinstance(x, _Rows) for x in ins):
                _refuse("concatenation along the lane axis")
            out = _Rows(r for x in ins for r in x)
        elif name == "broadcast_in_dim":
            (x,) = ins
            if out_aval.ndim != 2 or (jnp.ndim(x) == 1 and not isinstance(
                    x, _Rows) and params["broadcast_dimensions"] != (1,)):
                _refuse("a broadcast that is not along rows")
            n_rows, lanes = params["shape"]
            if isinstance(x, _Rows):
                rows = list(x) * (n_rows if len(x) == 1 else 1)
            else:
                rows = [x] * n_rows
            out = _Rows(jnp.broadcast_to(r, (lanes,)) for r in rows)
        elif name in ("squeeze", "reshape"):
            (x,) = ins
            if isinstance(x, _Rows) and len(x) == 1 and out_aval.ndim <= 1:
                out = x[0].reshape(out_aval.shape)   # one row -> (n_lane,)
            elif not isinstance(x, _Rows) and out_aval.ndim == 2 and \
                    out_aval.shape[0] == 1:
                out = _Rows([x.reshape(out_aval.shape[1:])])
            elif jnp.ndim(x) == 0 and out_aval.ndim == 0:
                out = x
            else:
                _refuse(f"a {name} that is not of one row")
        elif name in _ROW_REDUCE:
            (x,) = ins
            if params["axes"] != (0,) or not isinstance(x, _Rows):
                _refuse("reductions over the lane axis")
            out = functools.reduce(_ROW_REDUCE[name], x)
        elif name in _CALLS:
            inner = params.get("jaxpr") or params["call_jaxpr"]
            out = _eval_rows(inner.jaxpr, inner.consts, ins)
        else:
            _refuse(f"primitive {name!r} has no per-row rule")
        if eqn.primitive.multiple_results:
            for v, o in zip(eqn.outvars, out):
                env[v] = o
        else:
            env[eqn.outvars[0]] = out
    return [read(v) for v in jaxpr.outvars]


def rows_call(fn, x_rows, th_rows, t):
    """Call a flat callable ``fn(x_cols, th, t)`` on per-block rows:
    ``x_rows[j][b]`` is row ``b`` of column ``j``, ``th_rows[i]`` row ``i``
    of the parameters.  Returns ``fn``'s output with every
    ``(n_block, n_lane)`` array as a list of rows (``None`` kept)."""

    def spec(rows):
        r = rows[0]
        return jax.ShapeDtypeStruct((len(rows),) + jnp.shape(r),
                                    jnp.result_type(r))

    closed, shape = jax.make_jaxpr(fn, return_shape=True)(
        [spec(c) for c in x_rows], spec(th_rows),
        jax.ShapeDtypeStruct(jnp.shape(t), jnp.result_type(t)))
    outs = _eval_rows(closed.jaxpr, closed.consts,
                      [_Rows(c) for c in x_rows] + [_Rows(th_rows), t])
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shape), outs)


def flat_call(fn, x_cols, th, t):
    """``fn(x_cols, th, t)`` on whole tiles, after checking at trace time
    (shapes only, no computation) that ``fn`` keeps to the flat contract,
    i.e. that :func:`rows_call` can evaluate it as the GPU kernels do."""
    def check(xs, th_, t_):
        rows_call(fn, [list(c) for c in xs], list(th_), t_)

    jax.eval_shape(check, list(x_cols), th, t)
    return fn(x_cols, th, t)
