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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,r,h,blk", [
    (1016, 32, 64, 1016),   # the prefill's tail call: ragged last 64-row tile
    (64, 4, 8, 16),         # r, h and b below one mma tile
])
def test_kernel_mma_tile_shapes_match_plain_version(card, n, r, h, blk, dtype):
    rnd = _normal(n + r, card)
    kw = dict(degree=4, scale=1.0 / h, block_size=blk, return_state=True)
    # z0: the state a previous call of the same heads returned
    _, zv0, zd0 = pc.polysketch_causal_torch(
        rnd(2, n, r) * 0.5, rnd(2, n, r) * 0.5, rnd(2, n, h), rnd(2, n, h),
        rnd(2, n, h), **kw)
    dt = getattr(torch, dtype)
    xs = [x.to(dt) for x in (rnd(2, n, r) * 0.5, rnd(2, n, r) * 0.5,
                             rnd(2, n, h), rnd(2, n, h), rnd(2, n, h))]
    before = pc.polysketch_causal_cuda.launches
    got, gzv, gzd = pc.polysketch_causal_cuda(*xs, zv0, zd0, **kw)
    want, wzv, wzd = pc.polysketch_causal_torch(*xs, zv0, zd0, **kw)
    torch.cuda.synchronize()
    assert pc.polysketch_causal_cuda.launches == before + 1
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    for z, wz in ((gzv, wzv), (gzd, wzd)):
        assert (z - wz).abs().max().item() <= 1e-4 * wz.abs().max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [77, 2040])
def test_poly_flash_kernel_ragged_tiles_match_plain_version(card, n, dtype):
    rnd = _normal(n, card)
    ln = lambda x: torch.nn.functional.layer_norm(x, (64,), eps=1e-6)  # noqa: E731
    dt = getattr(torch, dtype)
    q, k, v = (x.to(dt) for x in (ln(rnd(2, n, 64)), ln(rnd(2, n, 64)), rnd(2, n, 64)))
    kw = dict(degree=4, scale=1.0 / 64)
    before = pf.poly_flash_cuda.launches
    got = pf.poly_flash_cuda(q, k, v, **kw)
    want = pf.poly_flash_torch(q, k, v, **kw)
    torch.cuda.synchronize()
    assert pf.poly_flash_cuda.launches == before + 1
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _lt_inputs(card, seed, bh, n, m, k, dtype=torch.float32):
    rnd = _normal(seed, card, dtype)
    return rnd(bh, n, m), rnd(bh, n, m), rnd(bh, n, k)


def test_lt_mult_kernel_is_bit_stable(card):
    a, b, c = _lt_inputs(card, 13, 4, 2048, 32, 64)
    first = lt.lt_mult_cuda(a, b, c, block_size=256)
    again = lt.lt_mult_cuda(a, b, c, block_size=256)
    assert torch.equal(first, again)


def test_lt_mult_kernel_row_alone_equals_batch(card):
    # At n 16384 the batch of 4 (512 query tiles of 128 rows) fills two CTAs
    # an SM, so its tiles run paired; the row alone (128 tiles) runs
    # unpaired: paired and unpaired must agree bit for bit.
    a, b, c = _lt_inputs(card, 14, 4, 16384, 32, 64)
    batch = lt.lt_mult_cuda(a, b, c, block_size=256)
    alone = lt.lt_mult_cuda(*(x[2:3].contiguous() for x in (a, b, c)), block_size=256)
    assert torch.equal(alone[0], batch[2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lt_mult_kernel_paired_odd_tiles_match_plain_version(card, dtype):
    # b 384 gives 3 query tiles a block; at bh 4 and 66 blocks the grid is
    # paired, and the middle CTA of each block takes its one tile alone.
    n, blk = 384 * 66, 384
    a, b, c = _lt_inputs(card, 15, 4, n, 32, 64, getattr(torch, dtype))
    got = lt.lt_mult_cuda(a, b, c, block_size=blk)
    want = lt.lt_mult_torch(a, b, c, block_size=blk)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == "bfloat16" else 2e-3
    torch.testing.assert_close(got.float(), want.float(), atol=tol * n, rtol=tol)
    # and to max|out|: f32 at the benchmark shape's gate (1e-5)
    rel = 2e-2 if dtype == "bfloat16" else 1e-5
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= rel * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,m,k,blk", [
    (48, 12, 20, 16),      # widths off the 8-wide mma tiles
    (256, 128, 128, 64),   # the widest m and k the kernel takes
])
def test_lt_mult_kernel_edge_widths_match_plain_version(card, n, m, k, blk, dtype):
    a, b, c = _lt_inputs(card, n + m, 2, n, m, k, getattr(torch, dtype))
    before = lt.lt_mult_cuda.launches
    got = lt.lt_mult_cuda(a, b, c, block_size=blk)
    want = lt.lt_mult_torch(a, b, c, block_size=blk)
    torch.cuda.synchronize()
    assert lt.lt_mult_cuda.launches == before + 1
    tol = 2e-2 if dtype == "bfloat16" else 2e-3
    torch.testing.assert_close(got.float(), want.float(), atol=tol * n,
                               rtol=tol)
