"""The bounds `chip_smoke.py` reports beside each kernel's time, computed on
the CPU from the shapes alone (no card, no JAX): the least time an H100
could take, on the tensor-core route (3xTF32) and on the f32 FMA pipes."""
import importlib.util
import pathlib

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (kernel, bound function's arguments, tensor-core ms, its limit, FMA ms, its limit)
CASES = [
    ("b3_bound", (4, 16384, 32, 64, 256), 0.01502, "bytes", 0.03215, "operations"),
    ("b3_bound", (4, 2048, 32, 64, 256), 0.001878, "bytes", 0.004019, "operations"),
    ("b1_bound", (48, 2048, 32, 64, 1024, 4), 0.2491, "operations", 0.5954, "operations"),
    ("b2_bound", (48, 2040, 64, 4), 0.1611, "operations", 0.3879, "operations"),
]


@pytest.mark.parametrize("fn,args,tc_ms,tc_by,fma_ms,fma_by", CASES)
def test_kernel_bounds(chip_smoke, fn, args, tc_ms, tc_by, fma_ms, fma_by):
    bd = getattr(chip_smoke, fn)(*args)
    assert bd.tc_ms == pytest.approx(tc_ms, rel=0.01)
    assert bd.fma_ms == pytest.approx(fma_ms, rel=0.01)
    assert (bd.tc_by, bd.fma_by) == (tc_by, fma_by)
    assert bd.tc_ms < bd.fma_ms
