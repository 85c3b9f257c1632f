"""One torch intra-op thread for the port's CPU tests.

Tier-1 runs the suite in several worker processes on one machine. With
torch's default of one intra-op thread a core in every worker, the
workers oversubscribe the cores, and the port's SMOKE-sized ops spend
their time handing work between threads: the port's test files took
1016 s under six workers on an 8-core machine with the default and 307 s
with one thread, all passing either way. A test module imports the
fixture below (after its `pytest.importorskip("torch")`) to run its tests
with one thread; the setting is restored when the module ends.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
