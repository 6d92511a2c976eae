"""
The Pallas-through-Triton filter and smoother kernels against the scan
driver of the same step functions (interpret mode on CPU, compiled on the
card), the per-row evaluation of the models' flat callables inside the
kernels and its check on every route, the platform decision, and the
kernels' Triton lowering.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rodeo_tpu.models import chkrebtii, fitzhugh, hes1, lorenz, seirah
from rodeo_tpu.ops import flat_rows
from rodeo_tpu.ops import pallas_kalman as pk
from rodeo_tpu.ops import scan as scan_mod
from rodeo_tpu.ops import triton_kalman as tk


@pytest.fixture
def on_gpu():
    """Skip unless JAX's default backend is a GPU (decided per test, not
    at import; the CPU test run pins the CPU)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; runs on the card via chip_smoke.py")


@pytest.fixture
def tile4(monkeypatch):
    """Four lanes per program, so small cases span several programs."""
    monkeypatch.setattr(tk, "LANE_TILE", 4)


def _filter_case(model, n_steps, n_lane, dt=0.01):
    """Scaled lane-batched filter inputs for a model's own setup, on a
    grid of step ``dt``."""
    cfg = model.setup(n_steps=n_steps, t_max=n_steps * dt,
                      dtype=jnp.float32)
    theta = cfg.pop("theta")
    n_theta = 1 if theta is None else theta.shape[0]
    base = jnp.ones((n_theta,), jnp.float32) if theta is None else theta
    thetas = base[None, :] * (1 + 0.01 * jnp.arange(n_lane)[:, None])
    inits = jnp.broadcast_to(cfg["ode_init"],
                             (n_lane,) + cfg["ode_init"].shape)
    s = pk._scaled_inputs(thetas, cfg["ode_weight"], inits, cfg["t_min"],
                          cfg["t_max"], n_steps, cfg["prior_pars"])
    pairs, _ = pk._tri_idx(s["x0_lanes"].shape[0])
    return dict(s=s, R=pk._pack_tri(s["Rs"], pairs).astype(jnp.float32),
                n_block=cfg["ode_weight"].shape[0])


def _run_both(flat, jac, mode, emit, case, n_steps, key=0):
    s = case["s"]
    q, n_block, n_lane = s["x0_lanes"].shape
    eps = None
    if mode == "chkrebtii":
        eps = jax.random.normal(jax.random.PRNGKey(key),
                                (n_steps, q, n_block, n_lane), jnp.float32)
    ref = pk.fused_filter_batch(
        flat, jac, n_steps, s["Qs"], s["Rs"], s["W_s"], s["x0_lanes"],
        s["theta_lanes"], s["tgrid"], s["t_vec"], raw_q_const=s["q_const"],
        mode=mode, eps=eps, emit=emit)
    out = tk.filter_batch(
        flat, jac, mode, emit, n_steps, s["q_const"],
        s["Qs"].astype(jnp.float32), case["R"],
        s["W_s"].astype(jnp.float32), s["x0_lanes"], s["theta_lanes"],
        s["tgrid"].astype(jnp.float32), s["t_vec"], eps, interpret=True)
    return ref, out


def _assert_close(ref, out):
    assert len(ref) == len(out)
    for a, b in zip(ref, out):
        assert a.shape == b.shape
        a, b = np.asarray(a), np.asarray(b)
        assert np.all(np.isfinite(b))
        scale = np.max(np.abs(a)) + 1e-30
        np.testing.assert_allclose(b / scale, a / scale, atol=2e-5)


@pytest.mark.parametrize("emit", ["states", "gains"])
@pytest.mark.parametrize("mode", ["kramer", "rodeo", "schober", "chkrebtii"])
def test_filter_kernel_matches_scan(mode, emit, tile4):
    """Every interrogation and both emits: the kernel (interpret mode)
    equals the scan driver of the same step function to f32 rounding."""
    case = _filter_case(fitzhugh, 32, 8, dt=0.05)
    jac = fitzhugh.fitzhugh_jac_flat if mode == "kramer" else None
    ref, out = _run_both(fitzhugh.fitzhugh_flat, jac, mode, emit, case, 32)
    _assert_close(ref, out)


@pytest.mark.parametrize("n_lane", [6, 5, 1])
def test_filter_kernel_odd_blocks_and_lanes(n_lane, tile4):
    """n_block = 3 (not a power of two: blocks are held as separate lane
    vectors, no padding) and lane counts that the lane tile does not
    divide (the tile stays; the last program's loads and stores are
    masked on the lane axis)."""
    case = _filter_case(lorenz, 24, n_lane)
    assert case["n_block"] == 3
    assert tk._lane_tile(n_lane) == {6: 4, 5: 4, 1: 1}[n_lane]
    ref, out = _run_both(lorenz.lorenz_flat, lorenz.lorenz_jac_flat,
                         "kramer", "gains", case, 24)
    _assert_close(ref, out)


def _smoother_both(n_lane):
    case = _filter_case(lorenz, 24, n_lane)
    s = case["s"]
    A, b, C, m, p = pk.fused_filter_batch(
        lorenz.lorenz_flat, lorenz.lorenz_jac_flat, 24, s["Qs"], s["Rs"],
        s["W_s"], s["x0_lanes"], s["theta_lanes"], s["tgrid"], s["t_vec"],
        raw_q_const=s["q_const"], emit="gains")
    ref = pk.smoother_recursion_batch(b[1:], A[1:], C[1:], m, p)
    out = tk.smoother_batch(b[1:], A[1:], C[1:], m, p, interpret=True)
    return ref, out


def test_smoother_kernel_matches_scan(tile4):
    """Backward recursion kernel == scan driver, on real filter gains."""
    _assert_close(*_smoother_both(8))


def test_smoother_kernel_masked_lanes(tile4):
    """A lane count the tile does not divide: the smoother's last program
    loads and stores under a lane mask, and equals the scan driver."""
    _assert_close(*_smoother_both(7))


@pytest.mark.parametrize("model, n_theta", [
    (lorenz, 3), (fitzhugh, 3), (hes1, 7), (seirah, 6), (chkrebtii, 1)])
def test_rows_call_matches_flat(model, n_theta):
    """The per-row evaluation of a flat callable (and of a jvp Jacobian)
    equals the callable on whole tiles, row by row."""
    name = model.__name__.rsplit(".", 1)[-1]
    flat = getattr(model, f"{name}_flat")
    n_block = model.setup()["ode_weight"].shape[0]
    rng = np.random.default_rng(0)
    lanes = 8
    x_cols = [jnp.asarray(rng.uniform(0.5, 1.5, (n_block, lanes)),
                          jnp.float32) for _ in range(3)]
    th = jnp.asarray(rng.uniform(0.5, 1.5, (n_theta, lanes)), jnp.float32)
    t = jnp.float32(0.3)
    jac = pk.jvp_jac_flat(flat, n_block, 3)
    for fn in (flat, jac):
        want = fn(x_cols, th, t)
        got = flat_rows.rows_call(fn, [list(c) for c in x_cols], list(th),
                                  t)
        want_l = want if isinstance(want, list) else [want]
        got_l = got if isinstance(want, list) else [got]
        for w, g in zip(want_l, got_l):
            assert (w is None) == (g is None)
            if w is not None:
                np.testing.assert_allclose(
                    np.stack([np.broadcast_to(r, (lanes,)) for r in g]),
                    np.asarray(w), rtol=1e-5, atol=1e-6)


_CONST = np.array([[1.0], [2.0], [3.0]], np.float32)
_IN_CONTRACT = {
    "row_index_stack": lambda x, th, t: jnp.stack(
        [x[0][0] * th[0], x[0][1], jnp.exp(x[0][2])]),
    "where": lambda x, th, t: jnp.where(x[0] > 1.0, x[0], -x[0]) * th[1:2],
    "clip": lambda x, th, t: jnp.clip(x[0], 0.8, 1.2) * th[0:1],
    "row_sum": lambda x, th, t: x[0] - jnp.sum(x[1], axis=0, keepdims=True),
    "row_const": lambda x, th, t: x[0] * _CONST + t,
    "vstack": lambda x, th, t: jnp.vstack([x[0][1:2], x[0][0:1], x[1][2:]]),
}
_OUT_OF_CONTRACT = {
    "matmul": lambda x, th, t: jnp.ones((3, 3), jnp.float32) @ x[0],
    "lane_sum": lambda x, th, t: x[0] * jnp.sum(x[0], axis=1, keepdims=True),
    "lane_slice": lambda x, th, t: jnp.concatenate(
        [x[0][:, 1:], x[0][:, :1]], axis=1),
}


@pytest.mark.parametrize("name", sorted(_IN_CONTRACT))
def test_rows_call_contract_ops(name):
    """Each kind of operation the flat contract allows evaluates per row
    exactly as on whole tiles, and passes the trace-time check."""
    fn = _IN_CONTRACT[name]
    rng = np.random.default_rng(1)
    x_cols = [jnp.asarray(rng.uniform(0.5, 1.5, (3, 8)), jnp.float32)
              for _ in range(3)]
    th = jnp.asarray(rng.uniform(0.5, 1.5, (3, 8)), jnp.float32)
    t = jnp.float32(0.3)
    got = flat_rows.rows_call(fn, [list(c) for c in x_cols], list(th), t)
    np.testing.assert_allclose(
        np.stack([np.broadcast_to(r, (8,)) for r in got]),
        np.asarray(fn(x_cols, th, t)), rtol=1e-6)
    np.testing.assert_array_equal(flat_rows.flat_call(fn, x_cols, th, t),
                                  fn(x_cols, th, t))


@pytest.mark.parametrize("name", sorted(_OUT_OF_CONTRACT))
def test_flat_contract_enforced_on_scan_route(name):
    """A flat callable outside the contract is refused at trace time on
    the CPU's scan driver too, not only inside the GPU kernels."""
    case = _filter_case(lorenz, 8, 8)
    s = case["s"]
    assert scan_mod.kernel_route() == "scan"
    with pytest.raises(NotImplementedError, match="flat callables"):
        pk.fused_filter_batch(
            _OUT_OF_CONTRACT[name], None, 8, s["Qs"], s["Rs"], s["W_s"],
            s["x0_lanes"], s["theta_lanes"], s["tgrid"], s["t_vec"],
            raw_q_const=s["q_const"])


def test_kernel_route_from_backend(monkeypatch):
    """The one platform decision: GPU -> Triton kernels, anything else ->
    the scan driver; the override context wins while it is active."""
    monkeypatch.setattr(scan_mod.jax, "default_backend", lambda: "gpu")
    assert scan_mod.kernel_route() == "triton"
    with scan_mod.fused_route("scan"):
        assert scan_mod.kernel_route() == "scan"
    assert scan_mod.kernel_route() == "triton"
    monkeypatch.setattr(scan_mod.jax, "default_backend", lambda: "cpu")
    assert scan_mod.kernel_route() == "scan"
    with pytest.raises(ValueError, match="route"):
        with scan_mod.fused_route("interpret"):
            pass


def test_gpu_route_calls_compiled_kernels(monkeypatch):
    """On a GPU backend the public entry points dispatch to the Triton
    kernels, compiled (never interpret mode)."""
    calls = []

    def record(name):
        def fake(*args, **kwargs):
            calls.append((name, kwargs))
            raise RuntimeError("dispatched")
        return fake

    monkeypatch.setattr(scan_mod.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(tk, "filter_batch", record("filter"))
    monkeypatch.setattr(tk, "smoother_batch", record("smoother"))
    case = _filter_case(fitzhugh, 8, 2, dt=0.05)
    s = case["s"]
    with pytest.raises(RuntimeError, match="dispatched"):
        pk.fused_filter_batch(
            fitzhugh.fitzhugh_flat, None, 8, s["Qs"], s["Rs"], s["W_s"],
            s["x0_lanes"], s["theta_lanes"], s["tgrid"], s["t_vec"],
            raw_q_const=s["q_const"])
    z = jnp.zeros((4, 3, 2, 2), jnp.float32)
    with pytest.raises(RuntimeError, match="dispatched"):
        pk.smoother_recursion_batch(z, jnp.zeros((4, 9, 2, 2)),
                                    jnp.zeros((4, 6, 2, 2)), z[0], z[0, :3])
    assert [c[0] for c in calls] == ["filter", "smoother"]
    assert all(not c[1].get("interpret", False) for c in calls)


def test_kernels_lower_to_triton():
    """Both kernels lower to Triton IR (the GPU compiler's input) at the
    bench's Lorenz63 widths, with and without a lane mask — catches
    primitives Triton cannot express before a run on the card."""
    from jax._src.pallas.triton import lowering

    def lower_all(fn, *args):
        found = 0
        for eqn in jax.make_jaxpr(fn)(*args).jaxpr.eqns:
            if eqn.primitive.name == "pallas_call":
                res = lowering.lower_jaxpr_to_triton_module(
                    eqn.params["jaxpr"], eqn.params["grid_mapping"], "cuda")
                assert res.module.operation.verify()
                found += 1
        return found

    f32 = jnp.float32
    for n_lane in (64, 48):            # 48: the last program is masked
        case = _filter_case(lorenz, 16, n_lane)
        s = case["s"]
        for emit in ("gains", "states"):
            assert lower_all(lambda x0, th: tk.filter_batch(
                lorenz.lorenz_flat, lorenz.lorenz_jac_flat, "kramer", emit,
                16, s["q_const"], s["Qs"].astype(f32), case["R"],
                s["W_s"].astype(f32), x0, th, s["tgrid"].astype(f32),
                s["t_vec"], None), s["x0_lanes"], s["theta_lanes"]) == 1
        g = jnp.zeros((16, 3, 3, n_lane), f32)
        assert lower_all(tk.smoother_batch, g,
                         jnp.zeros((16, 9, 3, n_lane), f32),
                         jnp.zeros((16, 6, 3, n_lane), f32), g[0],
                         jnp.zeros((6, 3, n_lane), f32)) == 1


@pytest.mark.gpu
def test_kernels_on_card_match_scan(on_gpu):
    """Compiled on the card: the Triton filter and smoother agree with the
    scan driver of the same step functions (short horizon, where f32
    reassociation has not been amplified); 100 lanes take the masked
    path of the last program."""
    for model, jac, mode, n_lane in (
            (lorenz, lorenz.lorenz_jac_flat, "kramer", 100),
            (fitzhugh, None, "rodeo", 96),
            (fitzhugh, None, "chkrebtii", 96)):
        name = model.__name__.rsplit(".", 1)[-1]
        case = _filter_case(model, 64, n_lane)
        s = case["s"]
        for emit in ("states", "gains"):
            eps = None
            if mode == "chkrebtii":
                q, nb, nl = s["x0_lanes"].shape
                eps = jax.random.normal(jax.random.PRNGKey(0),
                                        (64, q, nb, nl), jnp.float32)

            def run(route):
                with scan_mod.fused_route(route):
                    return jax.jit(lambda x0: pk.fused_filter_batch(
                        getattr(model, f"{name}_flat"), jac, 64, s["Qs"],
                        s["Rs"], s["W_s"], x0, s["theta_lanes"], s["tgrid"],
                        s["t_vec"], raw_q_const=s["q_const"], mode=mode,
                        eps=eps, emit=emit))(s["x0_lanes"])

            _assert_close(run("scan"), run("triton"))
            if emit == "gains":
                A, b, C, m, p = run("scan")
                with scan_mod.fused_route("triton"):
                    out = pk.smoother_recursion_batch(b[1:], A[1:], C[1:],
                                                      m, p)
                with scan_mod.fused_route("scan"):
                    ref = pk.smoother_recursion_batch(b[1:], A[1:], C[1:],
                                                      m, p)
                _assert_close(ref, out)
