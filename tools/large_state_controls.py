"""
One-off f32-on-CPU control measurement for the large-state inference
bench rows (VERDICT r4 #3: every *_grad_rel_err row needs an f32-CPU
control sibling).

Runs the SAME f32 pipelines the device bench rows run, on CPU, and prints a
JSON dict of control values + rel errors vs the cached f64 exact-mode
references (bench.py _LF_REF_* / _LD_REF_*, 2026-08-19/20 720 s runs).
The printed numbers are pasted into bench.py _LS_F32CPU_CONTROLS as
dated constants: recomputing them per bench run would add ~10 CPU-min
to every round.

Usage:  python tools/large_state_controls.py
"""
import json
import os
import sys
import time

import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from rodeo_tpu.models import heat                      # noqa: E402
from rodeo_tpu.ops import precond                      # noqa: E402
from rodeo_tpu.ops.stationary import (                 # noqa: E402
    fenrir_stationary, dalton_stationary)

# f64 CPU exact-mode references (bench.py cached constants)
LF_REF_LL = 8164.0849596394
LF_REF_G = 39105.2491452824

out = {"platform": str(jax.devices()[0]), "x64": False}

kw, kappa0 = heat.fenrir_setup(
    d=128, n_deriv=3, n_steps=1000, n_obs=20, dtype=jnp.float32)

for tag, nw in (("nw32", 32), ("exact", 1000)):
    t0 = time.time()
    v, g = jax.value_and_grad(
        lambda k: fenrir_stationary(
            n_deriv=3, n_warm=nw, kappa=k, validate=False, **kw))(kappa0)
    out[f"fenrir_{tag}_ll_f32cpu"] = float(v)
    out[f"fenrir_{tag}_grad_f32cpu"] = float(g)
    out[f"fenrir_{tag}_ll_rel"] = abs(float(v) - LF_REF_LL) / abs(LF_REF_LL)
    out[f"fenrir_{tag}_grad_rel"] = abs(float(g) - LF_REF_G) / abs(LF_REF_G)
    out[f"fenrir_{tag}_seconds"] = round(time.time() - t0, 1)
    print(json.dumps(out), flush=True)

t0 = time.time()
v, g = jax.value_and_grad(
    lambda k: dalton_stationary(
        n_deriv=3, n_warm=32, kappa=k, validate=False, **kw))(kappa0)
out["dalton_nw32_ll_f32cpu"] = float(v)
out["dalton_nw32_grad_f32cpu"] = float(g)
out["dalton_nw32_ll_rel"] = abs(float(v) - LF_REF_LL) / abs(LF_REF_LL)
out["dalton_nw32_grad_rel"] = abs(float(g) - LF_REF_G) / abs(LF_REF_G)
out["dalton_nw32_seconds"] = round(time.time() - t0, 1)
print(json.dumps(out), flush=True)

# daltonng dense path on the same fixture (the bench row's exact config)
import numpy as np                                      # noqa: E402
kw_ng = dict(kw)
y_ng = kw_ng.pop("obs_data")
kw_ng.pop("obs_weight")
kw_ng.pop("obs_var")
_sd, _p = 0.01, 3
_c = 128 * (np.log(_sd) + 0.5 * np.log(2 * np.pi))


def obs_ll_ng(y_i, x_i, i, **params):
    u = x_i[0, ::_p]
    return jnp.sum(-0.5 * ((y_i[0] - u) / _sd) ** 2) - _c


t0 = time.time()
v, g = jax.value_and_grad(
    lambda k: precond.daltonng(
        obs_data=y_ng, obs_loglik_i=obs_ll_ng, n_deriv=3,
        kappa=k, **kw_ng))(kappa0)
out["daltonng_ll_f32cpu"] = float(v)
out["daltonng_grad_f32cpu"] = float(g)
out["daltonng_ll_rel"] = abs(float(v) - LF_REF_LL) / abs(LF_REF_LL)
out["daltonng_grad_rel"] = abs(float(g) - LF_REF_G) / abs(LF_REF_G)
out["daltonng_seconds"] = round(time.time() - t0, 1)
print(json.dumps(out), flush=True)
print("CONTROLS_DONE")
