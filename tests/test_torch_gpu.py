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


def _grads(fn, xs, dout):
    leaves = [x.detach().clone().requires_grad_(True) for x in xs]
    return torch.autograd.grad(fn(*leaves), leaves, dout)


def _assert_grads_close(got, want, rel=1e-4):
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= rel * w.abs().max().item()


@pytest.mark.parametrize("degree", [2, 4, 8])
@pytest.mark.parametrize("local_exact", [True, False])
def test_backward_kernel_matches_plain_version(card, degree, local_exact):
    """ops.polysketch_attention's gradients through B1's backward kernel
    against the plain backward, GQA 4:2, each within 1e-4 of its max|.|."""
    xs = _inputs(degree, (2, 4, 96), (2, 2, 96), 16, 8, torch.float32, card)
    dout = _normal(degree + 1, card)(2, 4, 96, 16)
    kw = dict(degree=degree, scale=1.0 / 16, local_exact=local_exact, block_size=32)
    before = pc.polysketch_causal_backward_cuda.launches
    got = _grads(lambda *a: ops.polysketch_attention(*a, **kw), xs, dout)
    want = _grads(lambda *a: ops.polysketch_attention(*a, impl="torch", **kw), xs, dout)
    torch.cuda.synchronize()
    assert pc.polysketch_causal_backward_cuda.launches == before + 1
    _assert_grads_close(got, want)


@pytest.mark.parametrize("n,r,h,blk", [
    (1016, 32, 64, 1016),   # a ragged last 64-row tile, one block
    (64, 4, 8, 16),         # r, h and b below one mma tile
    (2048, 32, 64, 512),    # four blocks: the suffix over three hops
])
def test_backward_kernel_tile_shapes_and_z0_match_plain_version(card, n, r, h, blk):
    rnd = _normal(n + r, card)
    kw = dict(degree=4, scale=1.0 / h, block_size=blk)
    _, zv0, zd0 = pc.polysketch_causal_torch(
        rnd(2, n, r) * 0.5, rnd(2, n, r) * 0.5, rnd(2, n, h), rnd(2, n, h),
        rnd(2, n, h), return_state=True, **kw)
    xs = (rnd(2, n, r) * 0.5, rnd(2, n, r) * 0.5, rnd(2, n, h), rnd(2, n, h),
          rnd(2, n, h), zv0, zd0)
    dout = rnd(2, n, h)

    def run(fwd, bwd):
        return lambda *a: pc.polysketch_causal_autograd(
            *a, fwd=fwd, bwd=bwd, **kw)[0]
    got = _grads(run(pc.polysketch_causal_cuda, pc.polysketch_causal_backward_cuda),
                 xs, dout)
    want = _grads(run(pc.polysketch_causal_torch, pc.polysketch_causal_backward_torch),
                  xs, dout)
    torch.cuda.synchronize()
    _assert_grads_close(got, want)


def test_backward_kernel_is_bit_stable(card):
    xs = _inputs(5, (1, 4, 2048), (1, 4, 2048), 64, 32, torch.float32, card)
    dout = _normal(6, card)(1, 4, 2048, 64)
    kw = dict(degree=4, scale=1.0 / 64, block_size=1024)
    a = _grads(lambda *x: ops.polysketch_attention(*x, **kw), xs, dout)
    b = _grads(lambda *x: ops.polysketch_attention(*x, **kw), xs, dout)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_smoke_training_grads_on_card_match_cpu(card):
    """One SMOKE loss's gradients: the card (B1's kernels) against the CPU
    (plain versions), per leaf within 1e-4 of the leaf's max|.|."""
    from repro_torch.train import make_loss_fn
    cfg = get_config("gpt2s-polysketch", smoke=True)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 41)))
    grads = {}
    for dev in (card, torch.device("cpu")):
        lm = build_model(cfg, device=dev, seed=3, trainable=True).lm
        before = pc.polysketch_causal_backward_cuda.launches
        loss, _ = make_loss_fn(cfg)(lm, {"tokens": toks.to(dev)})
        loss.backward()
        launched = pc.polysketch_causal_backward_cuda.launches - before
        assert launched == (cfg.n_layers if dev.type == "cuda" else 0)
        grads[dev.type] = {n: p.grad.cpu() for n, p in lm.named_parameters()}
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        assert (got - want).abs().max() <= 1e-4 * want.abs().max(), name


# B1's backward tiles its state work 128 rows a CTA and its diagonal 64
# rows a CTA against 32-row stages of the other side: blocks smaller than
# one state tile, ragged tiles and stages, the training shape at other
# degrees and without local_exact.
@pytest.mark.parametrize("n,b,degree,local_exact", [
    (192, 96, 4, True),      # a block smaller than one 128-row state tile
    (400, 200, 4, True),     # a ragged second state tile (and 64-row tile)
    (2032, 1016, 4, True),   # ragged at 128-row tiles and at 32-row stages
    (4096, 1024, 8, True),   # the training shape at degree 8
    (4096, 1024, 1, True),   # degree 1: dS takes x^0 = 1
    (4096, 1024, 4, False),  # the training shape without local_exact
])
def test_backward_kernel_state_and_diagonal_tiling_match_plain_version(
        card, n, b, degree, local_exact):
    xs = _inputs(n + degree, (2, 12, n), (2, 12, n), 64, 32, torch.float32, card)
    if degree == 1:
        # At degree 1 the weights are signed (W = S scale); over 1024 keys
        # 1 + den then crosses zero and both versions' f32 gradients blow up
        # (to ~1e9). Nonnegative q and k keep every weight >= 0 and 1 + den
        # >= 1, so that the case holds the kernel, not the conditioning.
        qm, km, q, k, v = xs
        xs = (qm, km, q.abs(), k.abs(), v)
    dout = _normal(n + 1, card)(2, 12, n, 64)
    kw = dict(degree=degree, scale=1.0 / 64, local_exact=local_exact, block_size=b)
    before = pc.polysketch_causal_backward_cuda.launches
    got = _grads(lambda *a: ops.polysketch_attention(*a, **kw), xs, dout)
    want = _grads(lambda *a: ops.polysketch_attention(*a, impl="torch", **kw), xs, dout)
    torch.cuda.synchronize()
    assert pc.polysketch_causal_backward_cuda.launches == before + 1
    _assert_grads_close(got, want)


def test_backward_kernel_seeded_z0_over_four_blocks_matches_plain_version(card):
    """A seeded z0 over 4 blocks of 1024 (the suffix over 3 hops), its
    gradient included."""
    rnd = _normal(31, card)
    n, r, h, b = 4096, 32, 64, 1024
    kw = dict(degree=4, scale=1.0 / h, block_size=b)
    _, zv0, zd0 = pc.polysketch_causal_torch(
        rnd(4, n, r) * 0.5, rnd(4, n, r) * 0.5, rnd(4, n, h), rnd(4, n, h),
        rnd(4, n, h), return_state=True, **kw)
    xs = (rnd(4, n, r) * 0.5, rnd(4, n, r) * 0.5, rnd(4, n, h), rnd(4, n, h),
          rnd(4, n, h), zv0, zd0)
    dout = rnd(4, n, h)

    def run(fwd, bwd):
        return lambda *a: pc.polysketch_causal_autograd(
            *a, fwd=fwd, bwd=bwd, **kw)[0]
    got = _grads(run(pc.polysketch_causal_cuda, pc.polysketch_causal_backward_cuda),
                 xs, dout)
    want = _grads(run(pc.polysketch_causal_torch, pc.polysketch_causal_backward_torch),
                  xs, dout)
    torch.cuda.synchronize()
    _assert_grads_close(got, want)


def test_backward_kernel_is_bit_stable_over_four_blocks(card):
    xs = _inputs(8, (1, 4, 4096), (1, 4, 4096), 64, 32, torch.float32, card)
    dout = _normal(9, card)(1, 4, 4096, 64)
    kw = dict(degree=4, scale=1.0 / 64, block_size=1024)
    a = _grads(lambda *x: ops.polysketch_attention(*x, **kw), xs, dout)
    b = _grads(lambda *x: ops.polysketch_attention(*x, **kw), xs, dout)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# B2's backward (csrc/poly_flash_bwd.cu): 128-key tiles claimed by a
# persistent grid, 32-query stages, dq summed in key order, causal, any n.

def _b2_inputs(seed, b, hq, hkv, n, h, degree, device):
    """q, k LayerNorm'd like the model's (|q|, |k| at odd degree, so that
    1 + den stays >= 1), v and dout O(1)."""
    rnd = _normal(seed, device)
    ln = lambda x: torch.nn.functional.layer_norm(x, (h,), eps=1e-6)  # noqa: E731
    q, k, v = ln(rnd(b, hq, n, h)), ln(rnd(b, hkv, n, h)), rnd(b, hkv, n, h)
    if degree % 2:
        q, k = q.abs(), k.abs()
    return (q, k, v), rnd(b, hq, n, h)


@pytest.mark.parametrize("degree", [1, 2, 4, 8])
@pytest.mark.parametrize("n,h,hkv", [(64, 64, 2), (77, 64, 2), (200, 64, 2), (200, 64, 1),
                                     (77, 16, 2)])
def test_b2_backward_kernel_matches_plain_version(card, degree, n, h, hkv):
    """ops.poly_attention's gradients through B2's backward kernel against
    the plain backward (bh 2; GQA 2:1 at hkv 1), each within 1e-4 of its
    max|.|."""
    xs, dout = _b2_inputs(degree + n, 1, 2, hkv, n, h, degree, card)
    kw = dict(degree=degree, scale=1.0 / h)
    before = pf.poly_flash_backward_cuda.launches
    got = _grads(lambda *a: ops.poly_attention(*a, **kw), xs, dout)
    want = _grads(lambda *a: ops.poly_attention(*a, impl="torch", **kw), xs, dout)
    torch.cuda.synchronize()
    assert pf.poly_flash_backward_cuda.launches == before + 1
    _assert_grads_close(got, want)


def test_b2_backward_kernel_is_bit_stable(card):
    xs, dout = _b2_inputs(5, 1, 4, 4, 2040, 64, 4, card)
    kw = dict(degree=4, scale=1.0 / 64)
    a = _grads(lambda *x: ops.poly_attention(*x, **kw), xs, dout)
    b = _grads(lambda *x: ops.poly_attention(*x, **kw), xs, dout)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("degree", [1, 4])
@pytest.mark.parametrize("n", [129, 1000])
def test_b2_backward_kernel_ragged_tiles_match_plain_version(card, degree, n):
    """n that is a multiple of neither the 128-key tile nor the 32-query
    stage: the ragged tile and stage against the plain backward."""
    xs, dout = _b2_inputs(31 + degree + n, 1, 2, 2, n, 64, degree, card)
    kw = dict(degree=degree, scale=1.0 / 64)
    got = _grads(lambda *a: ops.poly_attention(*a, **kw), xs, dout)
    want = _grads(lambda *a: ops.poly_attention(*a, impl="torch", **kw), xs, dout)
    torch.cuda.synchronize()
    _assert_grads_close(got, want)


def test_b2_backward_kernel_more_items_than_resident_ctas(card):
    """bh 48 x 16 key tiles = 768 work items, several for each CTA of the
    persistent grid: against the plain backward, and three calls bit for
    bit (dq is summed in key order whatever the schedule)."""
    xs, dout = _b2_inputs(41, 1, 48, 48, 2048, 64, 4, card)
    q, k, v, dout = (x.reshape(48, 2048, 64).contiguous() for x in (*xs, dout))
    kw = dict(degree=4, scale=1.0 / 64)
    out, den = pf.poly_flash_cuda(q, k, v, return_den=True, **kw)
    runs = [pf.poly_flash_backward_cuda(dout, q, k, v, out, den, **kw) for _ in range(3)]
    want = pf.poly_flash_backward_torch(dout, q, k, v, out, den, **kw)
    torch.cuda.synchronize()
    _assert_grads_close(runs[0], want)
    for again in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], again))


# B2's backward in bf16 at h 64 and 128 and in f32 at h 128 (64-key items
# whose two warpgroups split the columns at h 128)
B2_WIDE = [("bfloat16", 64), ("bfloat16", 128), ("float32", 128)]


@pytest.mark.parametrize("dtype,h", B2_WIDE)
@pytest.mark.parametrize("degree", [1, 2, 4, 8])
@pytest.mark.parametrize("n,hkv", [(77, 2), (200, 2), (200, 1)])
def test_b2_backward_kernel_bf16_and_h128_match_plain_version(card, dtype, h, degree, n,
                                                              hkv):
    """ops.poly_attention's gradients through B2's backward kernel against
    the plain backward in the inputs' dtype (bh 2; GQA 2:1 at hkv 1), each
    within TOL[dtype] of its max|.|, returned in that dtype."""
    dt = getattr(torch, dtype)
    xs, dout = _b2_inputs(degree + n + h, 1, 2, hkv, n, h, degree, card)
    xs, dout = tuple(x.to(dt) for x in xs), dout.to(dt)
    kw = dict(degree=degree, scale=1.0 / h)
    before = pf.poly_flash_backward_cuda.launches
    got = _grads(lambda *a: ops.poly_attention(*a, **kw), xs, dout)
    want = _grads(lambda *a: ops.poly_attention(*a, impl="torch", **kw), xs, dout)
    torch.cuda.synchronize()
    assert pf.poly_flash_backward_cuda.launches == before + 1
    assert all(g.dtype == dt for g in got)
    _assert_grads_close([g.float() for g in got], [w.float() for w in want], TOL[dtype])


@pytest.mark.parametrize("dtype,h", B2_WIDE)
def test_b2_backward_kernel_bf16_and_h128_more_items_than_ctas_bit_stable(card, dtype, h):
    """bh 48, n 2048 (768 or 1536 work items over the persistent grid):
    against the plain backward, and three calls bit for bit."""
    dt = getattr(torch, dtype)
    xs, dout = _b2_inputs(43 + h, 1, 48, 48, 2048, h, 4, card)
    q, k, v, dout = (x.reshape(48, 2048, h).to(dt).contiguous() for x in (*xs, dout))
    kw = dict(degree=4, scale=1.0 / h)
    out, den = pf.poly_flash_cuda(q, k, v, return_den=True, **kw)
    runs = [pf.poly_flash_backward_cuda(dout, q, k, v, out, den, **kw) for _ in range(3)]
    want = pf.poly_flash_backward_torch(dout, q, k, v, out, den, **kw)
    torch.cuda.synchronize()
    _assert_grads_close([g.float() for g in runs[0]], [w.float() for w in want], TOL[dtype])
    for again in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], again))


def test_b2_forward_den_out_keeps_the_outputs_bits(card):
    (q, k, v), _ = _b2_inputs(6, 1, 4, 4, 2040, 64, 4, card)
    q, k, v = (x.reshape(4, 2040, 64).contiguous() for x in (q, k, v))
    kw = dict(degree=4, scale=1.0 / 64)
    out = pf.poly_flash_cuda(q, k, v, **kw)
    out_d, den = pf.poly_flash_cuda(q, k, v, return_den=True, **kw)
    _, want_den = pf.poly_flash_torch(q, k, v, return_den=True, **kw)
    assert torch.equal(out, out_d)
    torch.testing.assert_close(den, want_den, atol=0, rtol=1e-5)


@pytest.mark.parametrize("attention", ["polynomial", "softmax"])
def test_baseline_smoke_training_grads_on_card_match_cpu(card, attention):
    """One SMOKE loss's gradients of the baselines: the card (B2's kernels
    for polynomial, plain ops for softmax) against the CPU, per leaf within
    1e-4 of the leaf's max|.|."""
    from repro_torch.train import make_loss_fn
    cfg = get_config("gpt2s-polysketch", smoke=True, attention=attention)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 41)))
    grads = {}
    for dev in (card, torch.device("cpu")):
        lm = build_model(cfg, device=dev, seed=3, trainable=True).lm
        before = pf.poly_flash_backward_cuda.launches
        loss, _ = make_loss_fn(cfg)(lm, {"tokens": toks.to(dev)})
        loss.backward()
        launched = pf.poly_flash_backward_cuda.launches - before
        on_card = dev.type == "cuda" and attention == "polynomial"
        assert launched == (cfg.n_layers if on_card else 0)
        grads[dev.type] = {n: p.grad.cpu() for n, p in lm.named_parameters()}
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        assert (got - want).abs().max() <= 1e-4 * want.abs().max(), name


# ---------------------------------------------------------------------------
# serving: per-row decode and the continuous-batching engine
# ---------------------------------------------------------------------------

SERVE_MECHS = ["polysketch", "polynomial", "softmax"]


@pytest.mark.parametrize("attention", SERVE_MECHS)
def test_per_row_decode_matches_batch1_decodes(card, attention):
    """Four slots at four depths (one polysketch row folding its block on
    this step) decode in one call as four batch-1 decodes do; the rows that
    do not fold keep z bit for bit."""
    cfg = get_config("gpt2s-polysketch", smoke=True, attention=attention)
    st = build_model(cfg, device=card, seed=2).state
    lens, max_len = [5, 15, 16, 33], 48
    rng = np.random.default_rng(0)
    with torch.inference_mode():
        slots = st.broadcast_slots(st.init_slot(max_len), 4)
        singles, feeds = [], []
        for si, n in enumerate(lens):
            toks = torch.from_numpy(rng.integers(0, 128, size=(1, n))).to(card)
            logits, cache = st.prefill(toks, st.init_slot(max_len))
            slots = st.slot_scatter(slots, cache, si)
            singles.append(cache)
            feeds.append(logits.argmax(-1))
        tok = torch.stack(feeds)
        logits, stepped = st.decode_step(tok, torch.tensor(lens, device=card),
                                         slots)
        for si, n in enumerate(lens):
            want, wcache = st.decode_step(tok[si:si + 1], n, singles[si])
            torch.testing.assert_close(logits[si:si + 1], want, atol=1e-5,
                                       rtol=1e-5)
            got = st.slot_gather(stepped, si)
            for a, b in zip(got, wcache):
                for x, y in zip(a[:-1], b[:-1]):
                    torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-5)
            if attention == "polysketch" and (n + 1) % cfg.lt_block_size:
                assert all(torch.equal(a.z, b.z) for a, b in
                           zip(got, st.slot_gather(slots, si)))


def _serve(model, order, *, slots=4):
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sampling import SamplingParams
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 128, size=n) for n in (5, 17, 33, 16, 40, 9)]
    samp = [SamplingParams(), SamplingParams(temperature=0.8, top_k=40,
                                             top_p=0.95, seed=1),
            SamplingParams(), SamplingParams(temperature=1.0, seed=2),
            SamplingParams(temperature=0.7, top_p=0.9, seed=3),
            SamplingParams()]
    eng = ServeEngine(model, slots=slots, max_len=64, logprobs=True,
                      overlap=True, prefill_budget=16)
    rid_of = {eng.submit(prompts[i], 8, sampling=samp[i]): i for i in order}
    return {rid_of[o.rid]: o.tokens for o in eng.run()}


@pytest.mark.parametrize("attention", SERVE_MECHS)
def test_engine_tokens_do_not_depend_on_submission_order(card, attention):
    cfg = get_config("gpt2s-polysketch", smoke=True, attention=attention)
    model = build_model(cfg, device=card, seed=5)
    fwd = _serve(model, range(6))
    rev = _serve(model, range(5, -1, -1))
    for i in range(6):
        np.testing.assert_array_equal(fwd[i], rev[i])


@pytest.mark.parametrize("attention,kernel", [("polysketch", "polysketch_causal"),
                                              ("polynomial", "poly_flash")])
def test_engine_runs_the_kernels_and_no_plain_version(card, attention, kernel,
                                                      monkeypatch):
    calls = []
    for name in ("polysketch_causal_torch", "poly_flash_torch"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name,
                            lambda *a, _fn=fn, **k: calls.append(1) or _fn(*a, **k))
    wrapper = {"polysketch_causal": pc.polysketch_causal_cuda,
               "poly_flash": pf.poly_flash_cuda}[kernel]
    before = wrapper.launches
    cfg = get_config("gpt2s-polysketch", smoke=True, attention=attention)
    _serve(build_model(cfg, device=card, seed=6), range(6))
    assert wrapper.launches > before and not calls


def _shared_prefix_run(model, prefix_cache=None, telemetry=None):
    """Six requests sharing a 4-block prefix (SMOKE block 16), half sampled,
    on 3 slots with overlap and a one-block budget: outputs by request."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sampling import SamplingParams
    rng = np.random.default_rng(11)
    shared = rng.integers(0, 128, 64)
    prompts = [np.concatenate([shared, rng.integers(0, 128, 9 + 5 * i)])
               for i in range(6)]
    eng = ServeEngine(model, slots=3, max_len=160, logprobs=True,
                      overlap=True, prefill_budget=16,
                      prefix_cache=prefix_cache, telemetry=telemetry)
    rid_of = {eng.submit(p, 6, sampling=SamplingParams(
        temperature=0.8, top_k=40, top_p=0.95, seed=i) if i % 2 else None): i
        for i, p in enumerate(prompts)}
    return {rid_of[o.rid]: o for o in eng.run()}, eng


def test_engine_prefix_hits_equal_a_cold_run_bit_for_bit(card, tmp_path):
    from repro_torch.serve.prefix_cache import PrefixCache
    from repro_torch.serve.telemetry import Telemetry, validate_trace
    model = build_model(get_config("gpt2s-polysketch", smoke=True),
                        device=card, seed=8)
    cold, _ = _shared_prefix_run(model)
    for _ in range(2):   # the memory tier, then a restart from the disk tier
        tel = Telemetry(trace=True, memory=True)
        warm, eng = _shared_prefix_run(
            model, PrefixCache(1 << 24, save_dir=str(tmp_path)), tel)
        for i, o in cold.items():
            np.testing.assert_array_equal(warm[i].tokens, o.tokens)
            np.testing.assert_array_equal(warm[i].logprobs, o.logprobs)
        st = eng.stats()
        assert st["prefix_cache"]["hits"] >= 3 and st["retraces"] == 0
        assert validate_trace(tel.export_trace()) == []
        assert tel.registry.get("serve_device_peak_bytes").value > 0
    assert st["prefix_cache"]["disk_loads"] >= 1


def test_stored_snapshots_are_never_aliased_on_the_card(card):
    from repro_torch.serve.prefix_cache import PrefixCache
    model = build_model(get_config("gpt2s-polysketch", smoke=True),
                        device=card, seed=9)
    pc = PrefixCache(1 << 24)
    _, eng = _shared_prefix_run(model, pc)
    keep = {k: [z.clone() for z in e.snapshot] for k, e in pc._entries.items()}
    pc.reset_stats()
    _, again = _shared_prefix_run(model, pc)   # every request restores, decodes
    assert again.stats()["prefix_cache"]["hits"] == 6
    for k, zs in keep.items():
        assert all(torch.equal(a, b) for a, b in zip(pc._entries[k].snapshot, zs))
    st = model.state
    _, cache = st.prefill(torch.arange(35, device=card)[None] % 128, max_len=64)
    snap = st.snapshot(cache)
    restored = st.restore(st.init_slot(64), snap, 32)
    ptrs = {z.untyped_storage().data_ptr() for z in snap}
    assert not any(n.z.untyped_storage().data_ptr() in ptrs
                   for n in list(cache) + list(restored))


# ---------------------------------------------------------------------------
# rematerialisation and the 32k context
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attention", ["polysketch", "polynomial", "softmax"])
def test_remat_gradients_equal_none_at_full_width(card, attention):
    """Full width (d_model 768, 12 heads of 64), 2 layers, 1 x 2048 tokens,
    under deterministic algorithms: one loss's gradients with remat "dots"
    and "full" equal "none"'s bit for bit, and the kernels' forward runs
    again in the backward (2 launches a layer, the backward 1)."""
    from repro_torch.train import make_loss_fn
    cfg = get_config("gpt2s-polysketch", attention=attention, n_layers=2)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, 2049))).to(card)
    fwd, bwd = {"polysketch": (pc.polysketch_causal_cuda, pc.polysketch_causal_backward_cuda),
                "polynomial": (pf.poly_flash_cuda, pf.poly_flash_backward_cuda)}.get(
                    attention, (None, None))
    grads = {}
    torch.use_deterministic_algorithms(True)
    try:
        for remat in ("none", "dots", "full"):
            c = cfg.replace(remat=remat)
            lm = build_model(c, device=card, seed=0, trainable=True).lm
            before = (fwd.launches, bwd.launches) if fwd else (0, 0)
            loss, _ = make_loss_fn(c)(lm, {"tokens": toks})
            loss.backward()
            if fwd:
                runs = 1 if remat == "none" else 2
                assert (fwd.launches - before[0], bwd.launches - before[1]) == \
                    (runs * cfg.n_layers, cfg.n_layers)
            grads[remat] = {n: p.grad for n, p in lm.named_parameters()}
    finally:
        torch.use_deterministic_algorithms(False)
    for remat in ("dots", "full"):
        for name, want in grads["none"].items():
            assert torch.equal(grads[remat][name], want), (remat, name)


def test_b1_backward_kernel_at_32k_matches_plain_version(card):
    """B1's forward and backward at n 32768 (bh 2, r 32, h 64, b 1024):
    the byte offsets of the 32k training shape's rows and states."""
    xs = _inputs(32, (1, 2, 32768), (1, 2, 32768), 64, 32, torch.float32, card)
    dout = _normal(33, card)(1, 2, 32768, 64)
    kw = dict(degree=4, scale=1.0 / 64, block_size=1024)
    with torch.no_grad():
        got = ops.polysketch_attention(*xs, **kw)
        want = ops.polysketch_attention(*xs, impl="torch", **kw)
    assert (got - want).abs().max().item() <= TOL["float32"]
    _assert_grads_close(_grads(lambda *a: ops.polysketch_attention(*a, **kw), xs, dout),
                        _grads(lambda *a: ops.polysketch_attention(*a, impl="torch", **kw),
                               xs, dout))


def test_b2_backward_kernel_at_32k_matches_plain_version(card):
    """B2's forward and backward at n 32768, bh 2: 256 key tiles, each
    stage of dq summed behind up to 256 of them."""
    xs, dout = _b2_inputs(34, 1, 2, 2, 32768, 64, 4, card)
    kw = dict(degree=4, scale=1.0 / 64)
    with torch.no_grad():
        got = ops.poly_attention(*xs, **kw)
        want = ops.poly_attention(*xs, impl="torch", **kw)
    assert (got - want).abs().max().item() <= TOL["float32"]
    _assert_grads_close(_grads(lambda *a: ops.poly_attention(*a, **kw), xs, dout),
                        _grads(lambda *a: ops.poly_attention(*a, impl="torch", **kw),
                               xs, dout))


def test_remat_product_ops_cover_what_the_card_dispatches(card):
    """Every matrix product a train-mode forward dispatches on the card,
    for the three mechanisms, is one that remat "dots" keeps."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import transformer

    class Ops(TorchDispatchMode):
        seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.add(func)
            return func(*args, **(kwargs or {}))

    toks = torch.zeros(1, 1024, dtype=torch.long, device=card)
    for attention in ("polysketch", "polynomial", "softmax"):
        cfg = get_config("gpt2s-polysketch", attention=attention, n_layers=1)
        lm = build_model(cfg, device=card, seed=0, trainable=True).lm
        with Ops():
            lm(toks, mode="train")
    products = {f for f in Ops.seen
                if any(k in str(f) for k in ("mm", "dot", "matmul", "linear", "einsum"))}
    assert products and products <= transformer.PRODUCT_OPS, products


# ---------------------------------------------------------------------------
# head width 128 (the registry's dense models), bf16 training, and C.1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("local_exact", [True, False])
def test_h128_forward_and_backward_match_plain_version(card, dtype, local_exact):
    """B1 and its backward at h 128, GQA 6:2 over two blocks and a ragged
    n (zero-padded to the block): outputs and every gradient within the
    dtype's gate of the plain versions' (gradients relative to max|.|)."""
    dt = getattr(torch, dtype)
    xs = _inputs(11, (1, 6, 400), (1, 2, 400), 128, 32, dt, card)
    dout = _normal(12, card)(1, 6, 400, 128).to(dt)
    kw = dict(degree=4, scale=1.0 / 128, local_exact=local_exact, block_size=256)
    before = pc.polysketch_causal_backward_cuda.launches
    with torch.no_grad():
        got = ops.polysketch_attention(*xs, **kw)
        want = ops.polysketch_attention(*xs, impl="torch", **kw)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    g = _grads(lambda *a: ops.polysketch_attention(*a, **kw), xs, dout)
    w = _grads(lambda *a: ops.polysketch_attention(*a, impl="torch", **kw), xs, dout)
    torch.cuda.synchronize()
    assert pc.polysketch_causal_backward_cuda.launches == before + 1
    assert all(x.dtype == dt for x in g)
    _assert_grads_close(g, w, rel=tol)


def test_h128_bf16_resume_is_bit_identical(card):
    """A bf16 prefill at h 128 (GQA 12:1) resumed at a block boundary from
    the state the kernel returned equals a cold one, outputs and state."""
    xs = _inputs(13, (1, 24, 768), (1, 2, 768), 128, 32, torch.bfloat16, card)
    kw = dict(degree=4, scale=1.0 / 128, block_size=256, return_state=True)
    full, zf = ops.polysketch_attention(*xs, **kw)
    o1, z1 = ops.polysketch_attention(*(x[..., :256, :] for x in xs), **kw)
    o2, z2 = ops.polysketch_attention(*(x[..., 256:, :] for x in xs), z0=z1, **kw)
    assert torch.equal(torch.cat([o1, o2], dim=-2), full)
    assert torch.equal(z2, zf)


@pytest.mark.parametrize("kernel", ["polysketch_causal", "poly_flash"])
def test_c1_forward_error_against_float64_at_32k(card, kernel):
    """C.1: at bh 12, n 32768, h 64 the forward kernels' outputs lie
    within 1e-5 of max|out| of a float64 plain version (the plain f32
    version within 3e-6): every 8-key step of W V (and each chunk of B1's
    fold) goes into a fresh accumulator, so the tensor cores' truncating
    adds do not pile up over the 512 key tiles. Accumulating in place, B2
    lay ~6e-5 off."""
    rnd = _normal(32, card)
    n, h = 32768, 64
    q, k, v = rnd(1, 12, n, h), rnd(1, 12, n, h), rnd(1, 12, n, h)
    with torch.no_grad():
        if kernel == "polysketch_causal":
            qm, km = rnd(1, 12, n, 32) * 0.5, rnd(1, 12, n, 32) * 0.5
            kw = dict(degree=4, scale=1.0 / h, block_size=1024)
            run = lambda *a, **k_: ops.polysketch_attention(*a, **kw, **k_)  # noqa: E731
            xs = (qm, km, q, k, v)
        else:
            ln = lambda x: torch.nn.functional.layer_norm(x, (h,), eps=1e-6)  # noqa: E731
            run = lambda *a, **k_: ops.poly_attention(*a, degree=4, scale=1.0 / h, **k_)  # noqa: E731
            xs = (ln(q), ln(k), v)
        got = run(*xs)
        plain = run(*xs, impl="torch")
        ref = run(*(x.double() for x in xs), impl="torch")
    top = ref.abs().max().item()
    e_kernel = (got.double() - ref).abs().max().item() / top
    e_plain = (plain.double() - ref).abs().max().item() / top
    assert e_kernel <= 1e-5 and e_plain <= 1e-5, (e_kernel, e_plain)


# ---------------------------------------------------------------------------
# the forwards on wgmma: 128-query CTAs of two warpgroups, 64-key tiles (32
# where a width is 128), bulk-copied tiles, bf16 without lo products
# ---------------------------------------------------------------------------

def _ln(x):
    return torch.nn.functional.layer_norm(x, (x.shape[-1],), eps=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [32, 64, 96, 128])
@pytest.mark.parametrize("causal,n,t", [
    (True, 200, 200),     # a ragged last 128-row tile and a ragged 64-key tile
    (True, 129, 129),     # one row past a CTA's tile
    (False, 100, 333),    # non-causal, t != n, t off every tile
])
def test_b2_forward_tiling_edges_match_plain_version(card, dtype, h, causal, n, t):
    """B2 (and its 1 + den) at widths on and off the 64- and 128-wide
    instantiations, n and t off the 128-row and 64-key tiles."""
    rnd = _normal(h + n, card)
    dt = getattr(torch, dtype)
    q, k, v = _ln(rnd(3, n, h)).to(dt), _ln(rnd(3, t, h)).to(dt), rnd(3, t, h).to(dt)
    kw = dict(degree=4, scale=1.0 / h, causal=causal)
    before = pf.poly_flash_cuda.launches
    got, den = pf.poly_flash_cuda(q, k, v, return_den=True, **kw)
    want, wden = pf.poly_flash_torch(q, k, v, return_den=True, **kw)
    torch.cuda.synchronize()
    assert pf.poly_flash_cuda.launches == before + 1
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(den, wden, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("local_exact", [True, False])
@pytest.mark.parametrize("r,h", [(16, 32), (32, 64), (64, 96), (32, 128), (64, 128)])
def test_b1_forward_tiling_edges_match_plain_version(card, dtype, local_exact, r, h):
    """B1 with a seeded z0 over two blocks of 200 rows (off the 128-row and
    64-key tiles), r and h on and off the instantiations' widths: outputs,
    1 + den, the saved Z_l and the returned state."""
    n, b = 400, 200
    rnd = _normal(r + h, card)
    kw = dict(degree=4, scale=1.0 / h, local_exact=local_exact, block_size=b)
    _, zv0, zd0 = pc.polysketch_causal_torch(
        rnd(2, n, r) * 0.5, rnd(2, n, r) * 0.5, rnd(2, n, h), rnd(2, n, h), rnd(2, n, h),
        return_state=True, **kw)
    dt = getattr(torch, dtype)
    xs = [x.to(dt) for x in (rnd(2, n, r) * 0.5, rnd(2, n, r) * 0.5, rnd(2, n, h),
                             rnd(2, n, h), rnd(2, n, h))]
    got = pc.polysketch_causal_cuda(*xs, zv0, zd0, return_saved=True, **kw)
    want = pc.polysketch_causal_torch(*xs, zv0, zd0, return_saved=True, **kw)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=tol, rtol=tol)
    for g, w in ((got[1], want[1]), (got[2], want[2]), (got[3][0], want[3][0]),
                 (got[3][2], want[3][2])):
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()


def _fwd_run(kernel, dtype, card):
    """(run(xs), xs) of a forward kernel at a shape over several CTAs and
    key tiles: B1 at bh 3, n 512, b 256, r 32, h 64; B2 causal at bh 3,
    n 700, h 64."""
    rnd = _normal(23, card)
    dt = getattr(torch, dtype)
    if kernel == "polysketch_causal":
        xs = [x.to(dt) for x in (rnd(3, 512, 32) * 0.5, rnd(3, 512, 32) * 0.5,
                                 rnd(3, 512, 64), rnd(3, 512, 64), rnd(3, 512, 64))]
        kw = dict(degree=4, scale=1.0 / 64, block_size=256, return_saved=True)
        return (lambda ys: pc.polysketch_causal_cuda(*ys, **kw)), xs
    xs = [x.to(dt) for x in (_ln(rnd(3, 700, 64)), _ln(rnd(3, 700, 64)), rnd(3, 700, 64))]
    return (lambda ys: pf.poly_flash_cuda(*ys, degree=4, scale=1.0 / 64,
                                          return_den=True)), xs


def _flat(out):
    return [x for o in out for x in (o if isinstance(o, tuple) else (o,))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["polysketch_causal", "poly_flash"])
def test_forward_kernel_is_bit_stable_and_a_head_alone_equals_batch(card, kernel, dtype):
    """Two calls give the same bits, and each head computed alone gives the
    bits it gets in the batch (outputs, 1 + den, the saved and returned
    state)."""
    run, xs = _fwd_run(kernel, dtype, card)
    first, again = _flat(run(xs)), _flat(run(xs))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    for i in range(xs[0].shape[0]):
        alone = _flat(run([x[i:i + 1].contiguous() for x in xs]))
        assert all(torch.equal(a, b[i:i + 1]) for a, b in zip(alone, first))


# ---------------------------------------------------------------------------
# the recurrent families (plain ops: SSD, RG-LRU, the sliding-window ring)
# ---------------------------------------------------------------------------

RECURRENT = ["mamba2-780m", "recurrentgemma-9b"]


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_smoke_on_card_matches_cpu(card, arch):
    """SMOKE (f32, weights from one CPU seed): greedy tokens past
    recurrentgemma's 32-token window equal the CPU's, logits within 1e-4."""
    cfg = get_config(arch, smoke=True)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(2, 45))
    on_card = generate(build_model(cfg, device=card, seed=4), prompt, 10)
    on_cpu = generate(build_model(cfg, device="cpu", seed=4), prompt, 10)
    assert torch.equal(on_card.tokens.cpu(), on_cpu.tokens)
    assert (on_card.logits_last.cpu() - on_cpu.logits_last).abs().max().item() <= 1e-4


@pytest.mark.parametrize("arch", RECURRENT)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recurrent_resume_is_bit_identical_on_card(card, arch, dtype):
    """A prefill resumed at a block boundary equals the cold one, logits
    and every layer's state, on the card (block 16, a ring of 32)."""
    cfg = get_config(arch, smoke=True, lt_block_size=16, compute_dtype=dtype)
    st = build_model(cfg, device=card, seed=5).state
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(1, 77))).to(card)
    with torch.inference_mode():
        cold_logits, cold = st.prefill(toks, max_len=96)
        _, part = st.prefill(toks[:, :48], max_len=96)
        logits, res = st.resume(toks[:, 48:], part, 48)
    assert torch.equal(logits, cold_logits)
    for a, b in zip(cold, res):
        for x, y in zip(a, b):
            assert torch.equal(x, y) if torch.is_tensor(x) else x == y


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_prefix_cache_hits_equal_cold_on_card(card, arch):
    """Shared 3-block prefix, suffixes off the block grid (the truncation
    split): the cached engine hits and emits the cold engine's tokens and
    log-probabilities bit for bit."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.prefix_cache import PrefixCache
    from repro_torch.serve.sampling import SamplingParams
    cfg = get_config(arch, smoke=True, lt_block_size=16)
    model = build_model(cfg, device=card, seed=7)
    rng = np.random.default_rng(8)
    shared = rng.integers(0, cfg.vocab_size, 48)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, 13 + 5 * i)])
               for i in range(4)]
    runs = {}
    for name, pc in (("cold", None), ("cached", PrefixCache(1 << 22))):
        eng = ServeEngine(model, slots=2, max_len=128, prefix_cache=pc, logprobs=True,
                          overlap=True, prefill_budget=32)
        for i, p in enumerate(prompts):
            eng.submit(p, 6, sampling=SamplingParams(temperature=0.8, seed=i) if i % 2
                       else SamplingParams())
        runs[name] = {o.rid: o for o in eng.run()}
        if pc is not None:
            assert pc.stats()["hits"] >= 2
    for rid, o in runs["cold"].items():
        assert np.array_equal(o.tokens, runs["cached"][rid].tokens)
        assert np.array_equal(o.logprobs, runs["cached"][rid].logprobs)


# ---------------------------------------------------------------------------
# the mixture-of-experts FFN (plain batched products, no port kernel)
# ---------------------------------------------------------------------------

MOE = ["dbrx-132b", "llama4-maverick-400b-a17b"]


def _moe_layer(arch, card, dtype, **over):
    from repro_torch.models import moe
    cfg = get_config(arch, smoke=True, **over)
    layer = moe.MoE(cfg, generator=torch.Generator().manual_seed(9), device=card)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)).to(card, getattr(torch, dtype))
    return moe, cfg, layer.requires_grad_(False), x


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_moe_dispatch_matches_dense_oracle_on_card(card, arch, dtype, groups):
    """Capacity factor 8.0 (nothing drops): the sort-based dispatch against
    the dense oracle on the card, relative to max|y|."""
    moe, cfg, layer, x = _moe_layer(arch, card, dtype, capacity_factor=8.0,
                                    moe_dispatch_groups=groups)
    with torch.inference_mode():
        got, _ = moe.moe_apply(layer, cfg, x)
        want = moe.moe_apply_dense_oracle(layer, cfg, x)
    assert (got.float() - want.float()).abs().max().item() \
        <= TOL[dtype] * want.float().abs().max().item()


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_is_bit_stable_and_matches_cpu_on_card(card, arch, dtype):
    """At the published capacity factor (drops): two calls give the same
    bits, the kept assignments and the stable top-k (ties by index) are
    the CPU's, and the outputs agree with the CPU's."""
    moe, cfg, layer, x = _moe_layer(arch, card, dtype)
    with torch.inference_mode():
        a, aux_a = moe.moe_apply(layer, cfg, x)
        b, aux_b = moe.moe_apply(layer, cfg, x)
        on_cpu, _ = moe.moe_apply(layer.cpu(), cfg, x.cpu())
        x32 = x.float()
        _, _, _, ids = moe.route(layer.to(card), cfg, x32.reshape(-1, cfg.d_model))
        _, _, _, ids_cpu = moe.route(layer.cpu(), cfg, x32.cpu().reshape(-1, cfg.d_model))
    assert torch.equal(a, b) and all(torch.equal(aux_a[k], aux_b[k]) for k in aux_a)
    if dtype == "float32":
        assert torch.equal(ids.cpu(), ids_cpu)
        assert torch.equal(moe.dispatch_plan(cfg, ids).keep.cpu(),
                           moe.dispatch_plan(cfg, ids_cpu).keep)
        assert (a.cpu() - on_cpu).abs().max().item() <= 1e-4
    vals, idx = moe.top_k(torch.tensor([[0.5, 0.5, 0.1, 0.5]], device=card), 3)
    assert idx.tolist() == [[0, 1, 3]]


@pytest.mark.parametrize("arch", MOE)
def test_moe_smoke_on_card_matches_cpu(card, arch):
    """SMOKE (f32, weights from one CPU seed): greedy tokens equal the
    CPU's, logits within 1e-4."""
    cfg = get_config(arch, smoke=True)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(2, 45))
    on_card = generate(build_model(cfg, device=card, seed=4), prompt, 10)
    on_cpu = generate(build_model(cfg, device="cpu", seed=4), prompt, 10)
    assert torch.equal(on_card.tokens.cpu(), on_cpu.tokens)
    assert (on_card.logits_last.cpu() - on_cpu.logits_last).abs().max().item() <= 1e-4


# the VLM's and the encoder-decoder's B1 shapes (chip_smoke phase 1 and 12):
# Whisper's decoder (20 heads of 64, MHA) at a ragged 228-token prefill
# block and at 448 training tokens padded to two blocks of 256; llava's
# 32 query heads of 128 over 8 kv heads (GQA 4:1) over 2048 tokens
XM_SHAPES = [((4, 20, 228), (4, 20, 228), 64, "bfloat16"),
             ((4, 20, 448), (4, 20, 448), 64, "bfloat16"),
             ((4, 20, 448), (4, 20, 448), 64, "float32"),
             ((4, 32, 2048), (4, 8, 2048), 128, "bfloat16")]


@pytest.mark.parametrize("shape_q,shape_kv,h,dtype", XM_SHAPES)
def test_b1_at_the_vlm_and_whisper_shapes_matches_plain_version(card, shape_q, shape_kv,
                                                                h, dtype):
    dt = getattr(torch, dtype)
    xs = _inputs(21, shape_q, shape_kv, h, 32, dt, card)
    dout = _normal(22, card)(*shape_q, h).to(dt)
    kw = dict(degree=4, scale=1.0 / h, block_size=256)
    before = pc.polysketch_causal_backward_cuda.launches
    with torch.no_grad():
        got = ops.polysketch_attention(*xs, **kw)
        want = ops.polysketch_attention(*xs, impl="torch", **kw)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    g = _grads(lambda *a: ops.polysketch_attention(*a, **kw), xs, dout)
    w = _grads(lambda *a: ops.polysketch_attention(*a, impl="torch", **kw), xs, dout)
    torch.cuda.synchronize()
    assert pc.polysketch_causal_backward_cuda.launches == before + 1
    _assert_grads_close(g, w, rel=tol)


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-large-v3"])
def test_vlm_and_whisper_smoke_serving_on_card_matches_cpu(card, arch):
    """SMOKE weights from one CPU seed, served greedily through the
    batch-dict make_serve_fns with image embeddings or frames: the same
    tokens on the card as on the CPU, the last logits within 1e-4."""
    from repro_torch.serve.engine import make_serve_fns
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 40))}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal((2, cfg.n_image_tokens, cfg.d_model),
                                                    ).astype(np.float32)
    else:
        batch["frames"] = rng.standard_normal((2, cfg.encoder_len, cfg.d_model)
                                              ).astype(np.float32)
    runs = []
    for dev in (card, "cpu"):
        prefill, decode = make_serve_fns(build_model(cfg, device=dev, seed=3))
        last, cache = prefill(batch)
        toks = []
        for i in range(8):
            tok = last.argmax(-1)
            toks.append(tok.cpu())
            last, cache = decode(tok[:, None], cache, 40 + i)
        runs.append((torch.stack(toks, 1), last.float().cpu()))
    assert torch.equal(runs[0][0], runs[1][0])
    torch.testing.assert_close(runs[0][1], runs[1][1], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("attention", ["polysketch", "polynomial"])
def test_replica_failover_is_bit_identical_on_card(card, attention):
    """A SMOKE fleet of two replicas on the card: a kill (after a
    checkpoint for polysketch; a cold prefill and a full replay for the
    KV state of exact polynomial attention) gives the fault-free run's
    tokens and log-probabilities bit for bit. The recovery replays at the
    engine's slot width, the shape of the live tick's cuBLAS products."""
    from repro_torch.serve import ChaosInjector, PrefixCache, ReplicaSet
    from repro_torch.serve.sampling import SamplingParams
    cfg = get_config("gpt2s-polysketch", smoke=True, attention=attention)
    model = build_model(cfg, device=card, seed=0)
    blk = cfg.lt_block_size
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (2 * blk + 5, 7, blk + 3)]
    sps = [SamplingParams(), SamplingParams(temperature=0.8, top_k=40, seed=7),
           SamplingParams(temperature=1.0, top_p=0.9, seed=11)]

    def run(chaos=None):
        pc = PrefixCache(1 << 28) if attention == "polysketch" else None
        rs = ReplicaSet(model, n_replicas=2, slots=4, max_len=256, prefix_cache=pc,
                        logprobs=True, overlap=True, chaos=chaos)
        gids = [rs.submit(p, 24, sampling=sp) for p, sp in zip(prompts, sps)]
        return gids, {o.rid: o for o in rs.run()}, rs

    gids0, outs0, _ = run()
    gids, outs, rs = run(ChaosInjector("kill@9:r0"))
    st = rs.stats()
    assert st["deaths"] == {"kill": 1} and st["recovered_installs"] >= 1
    assert not rs.unarmed_deaths
    if attention == "polysketch":
        assert st["checkpoints"] >= 1
    for g, g0 in zip(gids, gids0):
        assert np.array_equal(outs[g].tokens, outs0[g0].tokens)
        assert np.array_equal(outs[g].logprobs, outs0[g0].logprobs)
