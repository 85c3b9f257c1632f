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
from repro_torch.kernels import lt_mult as lt  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import poly_flash as pf  # noqa: E402
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


def _normal(seed, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(device, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("degree", [4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_poly_flash_kernel_matches_plain_version(card, degree, causal, dtype):
    n = _normal(degree + causal, card, getattr(torch, dtype))
    q, k, v = (n(2, 2, 128, 16) for _ in range(3))
    kw = dict(degree=degree, scale=1.0 / 16, causal=causal)
    before = pf.poly_flash_cuda.launches
    got = ops.poly_attention(q, k, v, **kw)
    want = ops.poly_attention(q, k, v, impl="torch", **kw)
    torch.cuda.synchronize()
    assert pf.poly_flash_cuda.launches == before + 1
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("shapes,causal", [
    (((2, 4, 64, 16), (2, 2, 64, 16)), True),     # GQA 4:2
    (((1, 2, 77, 16), (1, 2, 77, 16)), True),     # n off the 64-row tile
    (((2, 2, 100, 64), (2, 2, 77, 64)), False),   # non-causal, n != t
])
def test_poly_flash_kernel_shapes_match_plain_version(card, shapes, causal):
    n = _normal(1, card)
    q, k, v = n(*shapes[0]), n(*shapes[1]), n(*shapes[1])
    kw = dict(degree=4, causal=causal)
    got = ops.poly_attention(q, k, v, **kw)
    want = ops.poly_attention(q, k, v, impl="torch", **kw)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,m,k,blk", [(64, 8, 16, 16), (128, 32, 8, 32),
                                       (96, 16, 16, 32), (256, 64, 64, 64),
                                       (512, 32, 128, 256)])
def test_lt_mult_kernel_matches_plain_version(card, n, m, k, blk, dtype):
    rnd = _normal(n + m, card, getattr(torch, dtype))
    a, b, c = rnd(2, n, m), rnd(2, n, m), rnd(2, n, k)
    before = lt.lt_mult_cuda.launches
    got = ops.lt_mult(a, b, c, block_size=blk)
    want = ops.lt_mult(a, b, c, block_size=blk, impl="torch")
    torch.cuda.synchronize()
    assert lt.lt_mult_cuda.launches == before + 1
    tol = 2e-2 if dtype == "bfloat16" else 2e-3
    torch.testing.assert_close(got.float(), want.float(), atol=tol * n,
                               rtol=tol)


@pytest.mark.parametrize("degree", [4, 8])
def test_polynomial_smoke_generate_on_card_matches_cpu(card, degree):
    cfg = get_config("gpt2s-polysketch", smoke=True, attention="polynomial",
                     poly_degree=degree)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 13))
    before = pf.poly_flash_cuda.launches
    on_card = generate(build_model(cfg, device=card, seed=3), prompt, 8)
    assert pf.poly_flash_cuda.launches == before + cfg.n_layers
    on_cpu = generate(build_model(cfg, device="cpu", seed=3), prompt, 8)
    assert torch.equal(on_card.tokens.cpu(), on_cpu.tokens)
    torch.testing.assert_close(on_card.logits_last.cpu(), on_cpu.logits_last,
                               atol=1e-4, rtol=1e-4)
