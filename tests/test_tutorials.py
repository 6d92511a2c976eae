"""
The executable tutorials double as integration tests (the reference
executes its myst-nb tutorials at doc build; see docs/run_tutorials.py).
"""
import pathlib
import subprocess
import sys

import pytest

DOCS = pathlib.Path(__file__).resolve().parent.parent / "docs"


@pytest.mark.parametrize("name", ["tutorial", "higher_order", "lorenz",
                                  "parameter"])
def test_tutorial_executes(name):
    out = subprocess.run(
        [sys.executable, str(DOCS / "run_tutorials.py"), name],
        capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert f"OK: {name}.md" in out.stdout
