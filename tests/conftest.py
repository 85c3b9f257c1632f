"""Shared pytest setup: make `src/` importable without PYTHONPATH=src and
register the custom markers used by the suite."""
import gc
import os
import sys

import pytest

_SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test (multi-process / simulated-mesh); "
        "deselect with -m 'not slow'")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the port's hand-written kernels); skips "
        "without one")


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_executables_between_modules():
    """Release compiled XLA executables when a test module finishes.

    The full suite compiles thousands of small CPU executables; on
    constrained runners the accumulated LLVM JIT state can crash the XLA
    *compiler* itself (segfault inside backend_compile) hundreds of tests
    in — observed on a 1-core container at different tests on different
    runs, independent of any particular change. Clearing jax's caches per
    module (plus a gc pass for engines whose collector callbacks form
    reference cycles) caps that accumulation; modules recompile what they
    share, which costs seconds against a suite that runs for minutes.
    """
    yield
    import jax
    jax.clear_caches()
    gc.collect()
