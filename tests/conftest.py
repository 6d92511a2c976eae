"""
Test configuration.

Tests run on CPU in float64 (matching the reference's `tox.ini` setting of
JAX_ENABLE_X64) with 8 virtual devices so that multi-device sharding logic
can be exercised without accelerator hardware.  These env vars must be set
before jax initializes its backends, hence this conftest (imported by
pytest before any test module).
"""
import os

# Force CPU: the tests run on the host, also on a machine with a GPU (card-
# only checks are marked ``gpu`` and run through chip_smoke.py instead).
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)


def pytest_collection_modifyitems(config, items):
    """Apply the ``slow`` marker from the measured-duration manifest.

    ``tests/slow_tests.txt`` lists every test that took >= 10 s on the
    1-core bench VM (regenerate from ``pytest --durations=0``); marking
    is data-driven so the two-tier split (``make smoke`` ~8 min vs
    ``make test`` ~85 min) never requires editing test files.  Unknown
    new tests default to the smoke tier until re-measured.
    """
    import pathlib
    import pytest

    manifest = pathlib.Path(__file__).parent / "slow_tests.txt"
    if not manifest.exists():
        return
    slow = {line.strip() for line in manifest.read_text().splitlines()
            if line.strip() and not line.startswith("#")}
    for item in items:
        if item.nodeid in slow:
            item.add_marker(pytest.mark.slow)
