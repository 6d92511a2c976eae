#!/usr/bin/env python3
"""Time the lane-batched fused solve on the GPU: the Triton kernels
against the scan driver of the same step functions.

Run from the repository root on a machine with a GPU:

    python tools/time_fused_solve.py            # kernel vs scan driver
    python tools/time_fused_solve.py --lanes 2048,2047   # other widths
    python tools/time_fused_solve.py --sweep    # plus lane tile x warps
    python tools/time_fused_solve.py --stages   # plus filter / smoother

Workload: ``solve_mv_fused_batch`` (forward filter + backward smoother +
assembly) on Lorenz63, 10,000 steps, ``t_max=20``, at 2048 lanes and at 1
lane (or the widths ``--lanes`` lists), end to end under ``jax.jit``.
Each configuration is timed in the
order kernel, scan, scan, kernel (so drift over the run does not favour
either), in steady state with ``jax.block_until_ready``; the printed
time is the mean of its two windows, per call and per solve.  With
``--stages`` the forward filter (``emit="gains"``) and the backward
smoother are also timed alone, on both drivers; assembly is the rest.
Prints the card's name and power limit first, and one JSON object last.
"""
import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def stage_timers(cfg, theta, n_lane):
    """Timers of the forward filter (gains) and the backward smoother of
    ``solve_mv_fused_batch``, alone, per driver."""
    import jax
    import jax.numpy as jnp
    from rodeo_tpu.models.lorenz import lorenz_flat, lorenz_jac_flat
    from rodeo_tpu.ops import pallas_kalman as pk
    from rodeo_tpu.ops.profile import _timeit
    from rodeo_tpu.ops.scan import fused_route

    thetas = jnp.broadcast_to(theta, (n_lane, 3))
    inits = jnp.broadcast_to(cfg["ode_init"],
                             (n_lane,) + cfg["ode_init"].shape)
    s = pk._scaled_inputs(thetas, cfg["ode_weight"], inits, cfg["t_min"],
                          cfg["t_max"], cfg["n_steps"], cfg["prior_pars"])

    def filt(x0, th):
        return pk.fused_filter_batch(
            lorenz_flat, lorenz_jac_flat, cfg["n_steps"], s["Qs"], s["Rs"],
            s["W_s"], x0, th, s["tgrid"], s["t_vec"],
            raw_q_const=s["q_const"], emit="gains")

    # a fresh jit per route: the route is fixed when a function is traced
    with fused_route("scan"):
        A, b, C, m, p = jax.block_until_ready(jax.jit(
            lambda x0, th: filt(x0, th))(s["x0_lanes"], s["theta_lanes"]))
    A, b, C = (jax.block_until_ready(a[1:]) for a in (A, b, C))
    timers = {"filter": {}, "smoother": {}}
    for route in ("triton", "scan"):
        with fused_route(route):
            f = jax.jit(lambda x0, th: filt(x0, th))
            jax.block_until_ready(f(s["x0_lanes"], s["theta_lanes"]))
            g = jax.jit(lambda *a: pk.smoother_recursion_batch(*a))
            jax.block_until_ready(g(b, A, C, m, p))
        timers["filter"][route] = (
            lambda f=f: _timeit(f, (s["x0_lanes"], s["theta_lanes"]),
                                n_rep=2, min_window=1.0)[0])
        timers["smoother"][route] = (
            lambda g=g: _timeit(g, (b, A, C, m, p), n_rep=2,
                                min_window=1.0)[0])
    return timers


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sweep", action="store_true",
                        help="also sweep the kernel's lane tile and warps")
    parser.add_argument("--stages", action="store_true",
                        help="also time the filter and smoother alone")
    parser.add_argument("--lanes", default="2048,1",
                        help="comma-separated lane counts (default 2048,1)")
    args = parser.parse_args()
    lane_counts = [int(n) for n in args.lanes.split(",")]

    import jax
    import jax.numpy as jnp
    from rodeo_tpu.models import lorenz
    from rodeo_tpu.ops import pallas_kalman, triton_kalman
    from rodeo_tpu.ops.profile import _timeit, use_compile_cache
    from rodeo_tpu.ops.scan import fused_route

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"needs a GPU; JAX found {dev.platform!r}", file=sys.stderr)
        return 2
    use_compile_cache(REPO)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}; {dev.device_kind}", flush=True)

    cfg = lorenz.setup(n_steps=10000, t_max=20.0, dtype=jnp.float32)
    theta = cfg.pop("theta")

    def solver(route, n_lane):
        thetas = jnp.broadcast_to(theta, (n_lane, 3)) * (
            1 + 1e-6 * jnp.arange(n_lane, dtype=jnp.float32)[:, None])
        inits = jnp.broadcast_to(cfg["ode_init"],
                                 (n_lane,) + cfg["ode_init"].shape)
        with fused_route(route):
            fn = jax.jit(lambda ts, x0: pallas_kalman.solve_mv_fused_batch(
                thetas=ts, ode_weight=cfg["ode_weight"], ode_inits=x0,
                t_min=cfg["t_min"], t_max=cfg["t_max"],
                n_steps=cfg["n_steps"], prior_pars=cfg["prior_pars"],
                ode_flat=lorenz.lorenz_flat,
                jac_flat=lorenz.lorenz_jac_flat))
            jax.block_until_ready(fn(thetas, inits))   # compile here
        return lambda: _timeit(fn, (thetas, inits), n_rep=2,
                               min_window=1.0)[0]

    result = {"card": card, "device_kind": dev.device_kind,
              "workload": "solve_mv_fused_batch Lorenz63 10k steps",
              "lane_tile": triton_kalman.LANE_TILE,
              "num_warps": triton_kalman.NUM_WARPS, "ms_per_call": {}}
    for n_lane in lane_counts:
        kern, scan = solver("triton", n_lane), solver("scan", n_lane)
        t = [kern(), scan(), scan(), kern()]
        k_ms, s_ms = (t[0] + t[3]) * 500, (t[1] + t[2]) * 500
        result["ms_per_call"][n_lane] = {"triton": k_ms, "scan": s_ms}
        print(f"{n_lane} lanes: triton {k_ms:.3f} ms, scan {s_ms:.3f} ms "
              f"per call ({k_ms / n_lane:.5f} / {s_ms / n_lane:.5f} ms "
              f"per solve)", flush=True)

    if args.stages:
        result["stage_ms_per_call"] = {}
        for n_lane in lane_counts:
            stages = stage_timers(cfg, theta, n_lane)
            res = {}
            for stage, fns in stages.items():
                t = [fns["triton"](), fns["scan"](), fns["scan"](),
                     fns["triton"]()]
                res[stage] = {"triton": (t[0] + t[3]) * 500,
                              "scan": (t[1] + t[2]) * 500}
                print(f"{n_lane} lanes, {stage}: triton "
                      f"{res[stage]['triton']:.3f} ms, scan "
                      f"{res[stage]['scan']:.3f} ms", flush=True)
            result["stage_ms_per_call"][n_lane] = res

    if args.sweep:
        sweep = {}
        default = (triton_kalman.LANE_TILE, triton_kalman.NUM_WARPS)
        for tile in (16, 32, 64, 128):
            for warps in (1, 2, 4):
                triton_kalman.LANE_TILE, triton_kalman.NUM_WARPS = \
                    tile, warps
                run = solver("triton", 2048)
                ms = (run() + run()) * 500
                sweep[f"tile{tile}_warps{warps}"] = ms
                print(f"2048 lanes, tile {tile}, {warps} warps: "
                      f"{ms:.3f} ms", flush=True)
        triton_kalman.LANE_TILE, triton_kalman.NUM_WARPS = default
        result["sweep_2048_ms_per_call"] = sweep
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
