"""Cases of the port that need a CUDA card (marker `gpu`); they skip
without one. The card's machine has no JAX, so this file imports only
torch, numpy and the port. Run there, from the repository root, with

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_gpu.py

(`--noconftest` because tests/conftest.py releases JAX caches).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import polysketch_causal as pc  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve.engine import generate  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = {"float32": 1e-4, "bfloat16": 5e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed, shape_q, shape_kv, hd, r, dtype, device):
    rng = np.random.default_rng(seed)
    n = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(device, dtype)
    return (n(*shape_q, r) * 0.5, n(*shape_kv, r) * 0.5, n(*shape_q, hd),
            n(*shape_kv, hd), n(*shape_kv, hd))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("degree", [2, 4, 8])
@pytest.mark.parametrize("local_exact", [True, False])
def test_kernel_matches_plain_version(card, degree, local_exact, dtype):
    xs = _inputs(degree, (2, 4, 96), (2, 2, 96), 16, 8,
                 getattr(torch, dtype), card)
    kw = dict(degree=degree, scale=1.0 / 16, local_exact=local_exact,
              block_size=32, return_state=True)
    before = pc.polysketch_causal_cuda.launches
    got, gz = ops.polysketch_attention(*xs, **kw)
    want, wz = ops.polysketch_attention(*xs, impl="torch", **kw)
    torch.cuda.synchronize()
    assert pc.polysketch_causal_cuda.launches == before + 1
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(gz, wz, atol=1e-3, rtol=1e-4)


def test_kernel_resume_is_bit_identical(card):
    xs = _inputs(7, (2, 4, 96), (2, 2, 96), 16, 8, torch.float32, card)
    kw = dict(degree=4, scale=1.0 / 16, block_size=32, return_state=True)
    full, zf = ops.polysketch_attention(*xs, **kw)
    o1, z1 = ops.polysketch_attention(*(x[..., :64, :] for x in xs), **kw)
    o2, z2 = ops.polysketch_attention(*(x[..., 64:, :] for x in xs), z0=z1,
                                      **kw)
    assert torch.equal(torch.cat([o1, o2], dim=-2), full)
    assert torch.equal(z2, zf)


def test_smoke_generate_on_card_matches_cpu(card):
    cfg = get_config("gpt2s-polysketch", smoke=True)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 13))
    before = pc.polysketch_causal_cuda.launches
    on_card = generate(build_model(cfg, device=card, seed=3), prompt, 8)
    assert pc.polysketch_causal_cuda.launches > before
    on_cpu = generate(build_model(cfg, device="cpu", seed=3), prompt, 8)
    assert torch.equal(on_card.tokens.cpu(), on_cpu.tokens)
    torch.testing.assert_close(on_card.logits_last.cpu(), on_cpu.logits_last,
                               atol=1e-4, rtol=1e-4)
