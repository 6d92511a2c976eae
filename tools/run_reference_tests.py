"""
Run the UPSTREAM reference's own unittest suite (`/root/reference/tests`)
against THIS package, by aliasing the ``rodeo`` import namespace to
``rodeo_tpu``.  Passing means upstream's tests — closed-form Gauss-Markov
oracles, naive-loop equivalence, jit/grad consistency, scipy smoke tests
(SURVEY §4) — all hold verbatim for the accelerator rebuild.

Run: python tools/run_reference_tests.py
"""
import os
import pathlib
import sys
import unittest

REPO = str(pathlib.Path(__file__).resolve().parent.parent)
REF_TESTS = "/root/reference/tests"
sys.path.insert(0, REPO)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from rodeo_tpu.compat import install_alias


def main():
    install_alias()
    sys.path.insert(0, REF_TESTS)
    loader = unittest.TestLoader()
    suite = loader.discover(REF_TESTS, pattern="test_*.py",
                            top_level_dir=REF_TESTS)
    runner = unittest.TextTestRunner(verbosity=1)
    result = runner.run(suite)
    sys.exit(0 if result.wasSuccessful() else 1)


if __name__ == "__main__":
    main()
