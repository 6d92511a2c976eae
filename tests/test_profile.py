"""profile_solve: the public step-cost probe must return sane per-eval
timings and the roofline bookkeeping; the peak table and the
compile-cache rule of the on-device scripts."""
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rodeo_tpu.ops import profile_solve
from rodeo_tpu.ops import profile

H100_F32_PEAK = profile.PEAKS["NVIDIA H100 80GB HBM3"]["f32_flops"]


def test_profile_solve_times_a_jitted_eval():
    @jax.jit
    def f(x):
        return jnp.sum(x * x)

    x = jnp.arange(1024.0)
    out = profile_solve(f, x, min_window=0.05)
    assert out["ms"] > 0
    assert abs(out["evals_per_sec"] - 1e3 / out["ms"]) \
        < 1e-6 * out["evals_per_sec"]
    assert "utilization" not in out


def test_profile_solve_roofline_fields():
    @jax.jit
    def f(x):
        return (x @ x).sum()

    x = jnp.ones((64, 64))
    flops = 2 * 64**3
    out = profile_solve(f, x, min_window=0.05, flops_per_eval=flops,
                        peak_flops=H100_F32_PEAK)
    assert out["flops_per_eval"] == flops
    assert np.isclose(out["achieved_flops"],
                      flops * out["evals_per_sec"], rtol=1e-6)
    assert np.isclose(out["utilization"],
                      out["achieved_flops"] / H100_F32_PEAK,
                      rtol=1e-6)


def test_profile_solve_per_and_kwargs():
    @jax.jit
    def f(x, scale=1.0):
        return jnp.sum(x) * scale

    x = jnp.ones((8, 100))
    a = profile_solve(f, x, per=8, min_window=0.05, scale=2.0)
    b = profile_solve(f, x, per=1, min_window=0.05, scale=2.0)
    # per=8 reports 1/8 of the per-call cost (same call, batched lanes)
    assert a["ms"] < b["ms"]


def test_device_peaks_known_and_unknown():
    """The peak table answers for the H100 and raises for any other
    device_kind — never a default peak."""
    h100 = types.SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")
    peaks = profile.device_peaks(h100)
    assert peaks["bf16_flops"] == 989e12
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(KeyError, match="no published peaks"):
        profile.device_peaks(types.SimpleNamespace(device_kind="cpu"))
    with pytest.raises(KeyError):
        profile.device_peaks(jax.devices("cpu")[0])


def test_compile_cache_rule_env_set(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR set: that directory, nothing set in code."""
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    monkeypatch.setattr(profile.jax.config, "update",
                        lambda *a: calls.append(a))
    assert profile.compile_cache_dir("/repo") == ("/elsewhere/cache", False)
    assert profile.use_compile_cache("/repo") == "/elsewhere/cache"
    assert calls == []


def test_compile_cache_rule_env_unset(monkeypatch):
    """Unset: the fixed <repo>/.jax_cache, set through jax.config."""
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(profile.jax.config, "update",
                        lambda *a: calls.append(a))
    want = os.path.join(os.path.abspath("/repo"), ".jax_cache")
    assert profile.compile_cache_dir("/repo") == (want, True)
    assert profile.compile_cache_dir("/repo", environ={}) == (want, True)
    assert profile.use_compile_cache("/repo") == want
    assert calls == [("jax_compilation_cache_dir", want)]
