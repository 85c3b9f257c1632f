"""Chip smoke of the PyTorch port: build its kernels, hold each against its
plain version on the card, serve gpt2s-polysketch and gpt2s-poly4 at full
width, and check the port against itself.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one, or without the repo's
`src/repro_torch` beside this file). Phases, each raising on failure:

  1. the B1 kernel (polysketch_causal) against its plain PyTorch version
     through ops.polysketch_attention, over the grid of the reference's
     kernel tests, at the slice's shape, and in the two calls each layer
     of a full-width 2040-token prefill makes (a 1024 block returning its
     state, then the 1016-token tail seeded with it); then the B2 kernel
     (poly_flash) through ops.poly_attention and the B3 kernel (lt_mult)
     through ops.lt_mult, over their reference grids and at the shapes
     their paths give them (B3 also bit for bit: two runs, and one bh
     row alone against the batch); and one line of tolerance study: the
     plain B1, B2 and B3 with single-pass TF32 matmuls against full f32,
     beside the kernels' (3xTF32) errors;
  2. full-width serving: `generate`, greedy, 4 requests x 2040 prompt
     tokens + 16 new ones, of gpt2s-polysketch (the decode fold at
     position 2047 runs) and of gpt2s-poly4 (exact polynomial attention,
     one prefill call into a KV cache of 2056), with every kernel's
     launches counted over exactly each run; B3's own path, ops.lt_mult
     at the kernel benchmark's shapes, likewise;
  3. self-checks: a polysketch prefill resumed at a block boundary equals
     a cold one bit for bit; a train-mode forward at full width launches
     its kernel once per layer and agrees with the plain path, for both
     models; the poly4 prefill's logits, kernel vs plain; SMOKE greedy
     tokens on the card equal those on the CPU, for both mechanisms;
  4. each kernel's time at its path's shapes beside its plain version's
     and its bounds (B1 also at the two calls a prefill's layer makes);
     B3's device time per pass (torch.profiler) and host time per call.

Prints the card's name and power limit, one `{"kernels": [...]}` line, and
as its last line `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.gpt2_paper import GPT2_SMALL_POLY4  # noqa: E402
from repro_torch.core import decode as dec  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import lt_mult as lt  # noqa: E402
from repro_torch.kernels import poly_flash as pf  # noqa: E402
from repro_torch.kernels import polysketch_causal as pc  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve.engine import generate  # noqa: E402

F32_TOL, BF16_TOL = 1e-4, 5e-2      # the reference's kernel-sweep tolerances
LT_F32_TOL, LT_BF16_TOL = 2e-3, 2e-2  # lt_mult's: atol tol * n, rtol tol
LT_BENCH_REL_TOL = 1e-5             # and max|err| / max|out| at kernel_bench's shapes
H100_F32_FLOPS = 67e12              # f32 outside the tensor cores (data sheet)
H100_TF32_FLOPS = 495e12            # TF32 on the tensor cores, dense (data sheet)
H100_BYTES_PER_S = 3.35e12          # HBM3 (data sheet)
KERNELS = {"polysketch_causal": pc.polysketch_causal_cuda,
           "poly_flash": pf.poly_flash_cuda, "lt_mult": lt.lt_mult_cuda}
NO_LIBRARY = "none: no single PyTorch call computes this function"


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def seeded(seed):
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        x = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(x).to("cuda", dtype)
    return rnd


def err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def check(name, got, tol):
    status = "ok" if got <= tol else "FAIL"
    log(f"  {name:58s} max|err| {got:.3e}  tol {tol:.0e}  {status}")
    if got > tol:
        raise AssertionError(f"{name}: max error {got} > {tol}")


def check_close(name, got, want, atol, rtol):
    """allclose(got, want, atol, rtol), as the reference's lt_mult tests
    hold it; returns the max abs error."""
    e = err(got, want)
    ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
    log(f"  {name:58s} max|err| {e:.3e}  atol {atol:.1e} rtol {rtol:.0e}  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: not within atol {atol}, rtol {rtol}")
    return e


def zero_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


# ---------------------------------------------------------------------------
# phase 1: B1 against its plain version
# ---------------------------------------------------------------------------

def phase_kernel_grid():
    log("phase 1: polysketch_causal kernel vs plain PyTorch (ops.polysketch_attention)")
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        for degree in (2, 4, 8):
            for local_exact in (True, False):
                rnd = seeded(degree)
                B, Hq, Hkv, S, hd, r, blk = 2, 4, 2, 96, 16, 8, 32
                qm = rnd(B, Hq, S, r, scale=0.5, dtype=dt)
                km = rnd(B, Hkv, S, r, scale=0.5, dtype=dt)
                q, k, v = (rnd(B, h_, S, hd, dtype=dt) for h_ in (Hq, Hkv, Hkv))
                kw = dict(degree=degree, scale=1.0 / hd, local_exact=local_exact,
                          block_size=blk)
                got = ops.polysketch_attention(qm, km, q, k, v, **kw)
                want = ops.polysketch_attention(qm, km, q, k, v, impl="torch", **kw)
                torch.cuda.synchronize()
                e = err(got, want)
                check(f"{str(dt)[6:]} p={degree} local_exact={local_exact} GQA 4:2", e, tol)
                if dt == torch.float32:
                    worst = max(worst, e)

    rnd = seeded(0)
    qm, km = rnd(1, 2, 77, 8), rnd(1, 2, 77, 8)
    q, k, v = rnd(1, 2, 77, 16), rnd(1, 2, 77, 16), rnd(1, 2, 77, 16)
    kw = dict(degree=4, scale=1.0 / 16, block_size=32)
    e = err(ops.polysketch_attention(qm, km, q, k, v, **kw),
            ops.polysketch_attention(qm, km, q, k, v, impl="torch", **kw))
    check("f32 unaligned n=77 (zero-padded to the block)", e, F32_TOL)
    worst = max(worst, e)

    for hq, hkv in ((2, 2), (4, 2)):
        rnd = seeded(7)
        B, S, hd, r, blk, cut = 2, 96, 16, 8, 32, 64
        qm, km = rnd(B, hq, S, r, scale=0.5), rnd(B, hkv, S, r, scale=0.5)
        q, k, v = rnd(B, hq, S, hd), rnd(B, hkv, S, hd), rnd(B, hkv, S, hd)
        kw = dict(degree=4, scale=1.0 / hd, block_size=blk, return_state=True)
        c = lambda x: x[..., :cut, :].contiguous()   # noqa: E731
        s = lambda x: x[..., cut:, :].contiguous()   # noqa: E731
        o_full, z_full = ops.polysketch_attention(qm, km, q, k, v, **kw)
        o1, z1 = ops.polysketch_attention(*map(c, (qm, km, q, k, v)), **kw)
        o2, z2 = ops.polysketch_attention(*map(s, (qm, km, q, k, v)), z0=z1, **kw)
        p2, pz2 = ops.polysketch_attention(*map(s, (qm, km, q, k, v)), z0=z1,
                                           impl="torch", **kw)
        torch.cuda.synchronize()
        e = max(err(o2, p2), err(z2, pz2) / pz2.abs().max().item())
        check(f"f32 resume at cut 64 with z0, {hq}:{hkv} heads (vs plain)", e, F32_TOL)
        worst = max(worst, err(o2, p2))
        same = torch.equal(torch.cat([o1, o2], -2), o_full) and torch.equal(z2, z_full)
        log(f"  resumed == one-shot, bit for bit ({hq}:{hkv} heads): {same}")
        if not same:
            raise AssertionError("kernel: resumed run differs from the one-shot run")

    rnd = seeded(1)
    qm, km = rnd(1, 3, 64, 4), rnd(1, 3, 64, 4)
    q, k, v = rnd(1, 3, 64, 8), rnd(1, 3, 64, 8), rnd(1, 3, 64, 8)
    kw = dict(degree=4, scale=1.0 / 8, block_size=16)
    full = ops.polysketch_attention(qm, km, q, k, v, **kw)
    solo = ops.polysketch_attention(*(x[:, 2:].contiguous() for x in (qm, km, q, k, v)), **kw)
    torch.cuda.synchronize()
    check("f32 per-head state reset (head 2 alone vs in the batch)",
          err(full[:, 2:], solo), 0.0)

    inputs = slice_inputs()
    kw = dict(degree=4, scale=1.0 / 64, block_size=1024, return_state=True)
    o, z = ops.polysketch_attention(*inputs, **kw)
    po, pz = ops.polysketch_attention(*inputs, impl="torch", **kw)
    torch.cuda.synchronize()
    e = err(o, po)
    check("f32 slice shape bh=4*12 n=2048 r=32 h=64 b=1024 (out)", e, F32_TOL)
    check("f32 slice shape, returned state (relative to max|z|)",
          err(z, pz) / pz.abs().max().item(), F32_TOL)
    worst = max(worst, e)

    # The two calls a full-width prefill of 2040 tokens makes per layer:
    # one full block that returns its state, then the 1016-token tail as a
    # block of its own length (partial tiles), seeded with that state.
    head = [x[..., :1024, :] for x in inputs]
    tail = [x[..., 1024:2040, :] for x in inputs]
    kw = dict(degree=4, scale=1.0 / 64, return_state=True)
    o1, z1 = ops.polysketch_attention(*head, block_size=1024, **kw)
    p1, pz1 = ops.polysketch_attention(*head, block_size=1024, impl="torch", **kw)
    o2, z2 = ops.polysketch_attention(*tail, block_size=1016, z0=z1, **kw)
    p2, pz2 = ops.polysketch_attention(*tail, block_size=1016, z0=z1,
                                       impl="torch", **kw)
    torch.cuda.synchronize()
    for name, (o, po, z, pz) in (("block n=b=1024", (o1, p1, z1, pz1)),
                                 ("tail n=b=1016 + z0", (o2, p2, z2, pz2))):
        e = err(o, po)
        check(f"f32 prefill {name}, bh=48 r=32 h=64 (out)", e, F32_TOL)
        check(f"f32 prefill {name}, bh=48 (state, rel.)",
              err(z, pz) / pz.abs().max().item(), F32_TOL)
        worst = max(worst, e)
    return worst


def phase_poly_flash_grid():
    log("phase 1: poly_flash kernel vs plain PyTorch (ops.poly_attention)")
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        for degree in (4, 8):
            for causal in (True, False):
                rnd = seeded(degree + causal)
                q, k, v = (rnd(2, 2, 128, 16, dtype=dt) for _ in range(3))
                kw = dict(degree=degree, scale=1.0 / 16, causal=causal)
                got = ops.poly_attention(q, k, v, **kw)
                want = ops.poly_attention(q, k, v, impl="torch", **kw)
                torch.cuda.synchronize()
                e = err(got, want)
                check(f"{str(dt)[6:]} p={degree} causal={causal} B=2 H=2 S=128 hd=16",
                      e, tol)
                if dt == torch.float32:
                    worst = max(worst, e)
    rnd = seeded(5)
    cases = (("f32 GQA 4:2, S=128", (2, 4, 128, 16), (2, 2, 128, 16), True),
             ("f32 unaligned n=77 (ragged tile, no padding)", (1, 2, 77, 16),
              (1, 2, 77, 16), True),
             ("f32 non-causal n=100, t=77, h=64", (2, 2, 100, 64), (2, 2, 77, 64),
              False),
             ("f32 non-causal n=64, t=96, hd=16", (2, 2, 64, 16), (2, 2, 96, 16),
              False))
    for name, sq, skv, causal in cases:
        q, k, v = rnd(*sq), rnd(*skv), rnd(*skv)
        kw = dict(degree=4, causal=causal)
        e = err(ops.poly_attention(q, k, v, **kw),
                ops.poly_attention(q, k, v, impl="torch", **kw))
        check(name, e, F32_TOL)
        worst = max(worst, e)
    for degree in (4, 8):
        q, k, v = poly_slice_inputs(2040)
        kw = dict(degree=degree, scale=1.0 / 64)
        e = err(ops.poly_attention(q, k, v, **kw),
                ops.poly_attention(q, k, v, impl="torch", **kw))
        torch.cuda.synchronize()
        check(f"f32 slice shape bh=4*12 n=2040 h=64 p={degree}", e, F32_TOL)
        worst = max(worst, e)
    return worst


def poly_slice_inputs(n):
    """q, k, v (4, 12, n, 64) as the poly4 prefill gives them: q and k
    LayerNorm'd (zero mean, unit variance per row), v O(1)."""
    rnd = seeded(12)
    q, k, v = rnd(4, 12, n, 64), rnd(4, 12, n, 64), rnd(4, 12, n, 64)
    ln = lambda x: torch.nn.functional.layer_norm(x, (64,), eps=1e-6)  # noqa: E731
    return ln(q), ln(k), v


LT_BENCH = dict(bh=4, m=32, k=64, blk=256)        # benchmarks/kernel_bench.py


def lt_bench_inputs(n):
    rnd = seeded(13)
    bh, m, k = LT_BENCH["bh"], LT_BENCH["m"], LT_BENCH["k"]
    return rnd(bh, n, m), rnd(bh, n, m), rnd(bh, n, k)


def phase_lt_mult_grid():
    log("phase 1: lt_mult kernel vs plain PyTorch (ops.lt_mult)")
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        tol = LT_F32_TOL if dt == torch.float32 else LT_BF16_TOL
        for n, m, k, blk in ((64, 8, 16, 16), (128, 32, 8, 32), (96, 16, 16, 32),
                             (256, 64, 64, 64)):
            rnd = seeded(n + m)
            a, b, c = rnd(2, n, m, dtype=dt), rnd(2, n, m, dtype=dt), rnd(2, n, k, dtype=dt)
            got = ops.lt_mult(a, b, c, block_size=blk)
            want = ops.lt_mult(a, b, c, block_size=blk, impl="torch")
            torch.cuda.synchronize()
            e = check_close(f"{str(dt)[6:]} n={n} m={m} k={k} block={blk}", got, want,
                            tol * n, tol)
            if dt == torch.float32:
                worst = max(worst, e)
    for n in (32, 64, 96):
        for blk in (16, 32):
            for seed in (0, 271, 828):
                rnd = seeded(seed)
                a, b, c = rnd(1, n, 8), rnd(1, n, 8), rnd(1, n, 4)
                got = ops.lt_mult(a, b, c, block_size=blk)
                want = ops.lt_mult(a, b, c, block_size=blk, impl="torch")
                e = err(got, want)
                if not torch.allclose(got, want, atol=1e-3, rtol=1e-3):
                    raise AssertionError(f"lt_mult property n={n} block={blk} "
                                         f"seed={seed}: max error {e}")
                worst = max(worst, e)
    log(f"  property grid (n 32/64/96 x block 16/32 x 3 seeds, m=8, k=4): all within "
        f"1e-3, worst max|err| so far {worst:.3e}")
    kw = dict(block_size=LT_BENCH["blk"])
    for n in (2048, 16384):
        a, b, c = lt_bench_inputs(n)
        got = ops.lt_mult(a, b, c, **kw)
        want = ops.lt_mult(a, b, c, impl="torch", **kw)
        torch.cuda.synchronize()
        e = check_close(f"f32 kernel_bench shape bh=4 m=32 k=64 block=256 n={n}",
                        got, want, LT_F32_TOL * n, LT_F32_TOL)
        # At n = 16384 the reference's atol (2e-3 * n) is ~33 against outputs
        # of a few hundred: hold the error to max|out| as well, so that a
        # wrong tile term (~|a.b| |c|) fails at this shape too.
        rel = e / want.abs().max().item()
        log(f"    (relative to max|out| {want.abs().max().item():.1f}: {rel:.2e}, "
            f"limit {LT_BENCH_REL_TOL:.0e})")
        if not rel <= LT_BENCH_REL_TOL:
            raise AssertionError(f"lt_mult kernel_bench shape n={n}: max error "
                                 f"{e} is {rel:.2e} of max|out|, above "
                                 f"{LT_BENCH_REL_TOL:.0e}")
        worst = max(worst, e)
    # b 384: 3 query tiles a block, on a paired grid (bh 4, 66 blocks), so
    # that the middle CTA of each block takes its one tile alone.
    rnd = seeded(15)
    pa, pb, pc_ = rnd(4, 384 * 66, 32), rnd(4, 384 * 66, 32), rnd(4, 384 * 66, 64)
    got_p = ops.lt_mult(pa, pb, pc_, block_size=384)
    want_p = ops.lt_mult(pa, pb, pc_, block_size=384, impl="torch")
    torch.cuda.synchronize()
    e = check_close("f32 paired, odd tiles bh=4 m=32 k=64 block=384 n=25344",
                    got_p, want_p, LT_F32_TOL * 384 * 66, LT_F32_TOL)
    rel = e / want_p.abs().max().item()
    log(f"    (relative to max|out|: {rel:.2e}, limit {LT_BENCH_REL_TOL:.0e})")
    if not rel <= LT_BENCH_REL_TOL:
        raise AssertionError(f"lt_mult paired grid b=384: max error {e} is {rel:.2e} of "
                             f"max|out|, above {LT_BENCH_REL_TOL:.0e}")
    # Bit for bit at n = 16384: a second run, and bh row 2 computed alone
    # (the batch runs paired query tiles, the row alone unpaired).
    again = ops.lt_mult(a, b, c, **kw)
    solo = ops.lt_mult(*(x[2:3].contiguous() for x in (a, b, c)), **kw)
    torch.cuda.synchronize()
    same, alone = torch.equal(again, got), torch.equal(solo[0], got[2])
    log(f"  f32 kernel_bench shape n=16384: two runs equal bit for bit: {same}; bh row 2 "
        f"alone equals it in the batch of 4, bit for bit: {alone}")
    if not (same and alone):
        raise AssertionError("lt_mult: not bit-stable across runs or across the batch")
    return worst


def phase_tolerance_study():
    """Why the kernels take three TF32 products per f32 product: at the
    slices' shapes (B3: kernel_bench's, n = 16384), the plain versions with
    single-pass TF32 matmuls (PyTorch's allow_tf32, never on the main path;
    set back to False after) and the kernels (3xTF32), each against the
    plain full-f32 result. B3's errors are shares of max|out|, as its gate
    holds them."""
    b1_in = slice_inputs()
    b1_kw = dict(degree=4, scale=1.0 / 64, block_size=1024)
    b2_in = poly_slice_inputs(2040)
    b2_kw = dict(degree=4, scale=1.0 / 64)
    b3_in = lt_bench_inputs(16384)
    b3_kw = dict(block_size=LT_BENCH["blk"])

    def plain():
        return (ops.polysketch_attention(*b1_in, impl="torch", **b1_kw),
                ops.poly_attention(*b2_in, impl="torch", **b2_kw),
                ops.lt_mult(*b3_in, impl="torch", **b3_kw))
    f32 = plain()
    kernel = (ops.polysketch_attention(*b1_in, **b1_kw), ops.poly_attention(*b2_in, **b2_kw),
              ops.lt_mult(*b3_in, **b3_kw))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = plain()
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    b3_max = f32[2].abs().max().item()
    log(f"  tolerance study (f32 slice shapes, max|err| against the plain full-f32 "
        f"result): one TF32 product (plain, allow_tf32) B1 {err(tf32[0], f32[0]):.3e}, "
        f"B2 {err(tf32[1], f32[1]):.3e}; 3xTF32 kernels B1 {err(kernel[0], f32[0]):.3e}, "
        f"B2 {err(kernel[1], f32[1]):.3e}; gate {F32_TOL:.0e}. B3 bh=4 n=16384, as a share "
        f"of max|out| {b3_max:.1f}: one TF32 product {err(tf32[2], f32[2]) / b3_max:.2e}, "
        f"3xTF32 kernel {err(kernel[2], f32[2]) / b3_max:.2e}; gate {LT_BENCH_REL_TOL:.0e}")


def slice_inputs():
    """Inputs at the slice's shape, scaled like the model's: q, k are
    LayerNorm'd (unit variance per row), the sketches are O(1)."""
    rnd = seeded(11)
    B, H, n, r, h = 4, 12, 2048, 32, 64
    return (rnd(B, H, n, r, scale=0.5), rnd(B, H, n, r, scale=0.5),
            rnd(B, H, n, h), rnd(B, H, n, h), rnd(B, H, n, h))


# ---------------------------------------------------------------------------
# phase 2: full-width serving through generate
# ---------------------------------------------------------------------------

def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_serve(model):
    log("phase 2: gpt2s-polysketch full width, greedy generate, 4 x (2040 + 16)")
    cfg = model.cfg
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(4, 2040))
    generate(model, prompts[:, :64], 2)            # warm-up (allocator, cuBLAS)
    zero_counts()
    res, dt = timed(lambda: generate(model, prompts, 16))
    run_counts = counts()
    launches = run_counts["polysketch_causal"]
    toks = res.tokens.cpu().numpy()
    if toks.shape != (4, 16) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"bad tokens {toks.shape} [{toks.min()}, {toks.max()}]")
    if not torch.isfinite(res.logits_last).all():
        raise AssertionError("non-finite logits")
    log(f"  layers {cfg.n_layers} x d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.resolved_head_dim}, block {cfg.lt_block_size}, r {cfg.sketch_size}")
    log(f"  generate: {dt * 1e3:.1f} ms for 4 x 16 tokens; B1 launches in the run: "
        f"{launches} (all kernels: {run_counts})")
    if launches <= 0:
        raise AssertionError("the main path never launched the B1 kernel")
    _, t_pre = timed(lambda: generate(model, prompts, 0))
    _, t_all = timed(lambda: generate(model, prompts, 16))
    decode_ms = (t_all - t_pre) * 1e3 / 16
    log(f"  prefill (generate, 0 new tokens): {t_pre * 1e3:.1f} ms; decode "
        f"{decode_ms:.2f} ms/token-step; {4 * 16 / t_all:.1f} generated tok/s "
        f"({4 * (2040 + 16) / t_all:.0f} tok/s prompt included)")
    for i, row in enumerate(toks):
        log(f"  req{i}: {' '.join(map(str, row.tolist()))}")
    profile_generate(model, prompts)
    return launches, prompts


def device_rows(prof):
    """The device-side rows of a torch.profiler run's key_averages()."""
    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")]


def dev_us(e) -> float:
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))


def profile_generate(model, prompts):
    """Device busy share and the top device kernels of one prefill and of
    the 16 decode steps, from torch.profiler (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for label, steps in (("prefill", 0), ("prefill+decode16", 16)):
        with profile(activities=acts) as prof:
            _, wall = timed(lambda: generate(model, prompts, steps))
        rows = device_rows(prof)
        busy = sum(dev_us(e) for e in rows) / 1e6
        log(f"  profile {label}: wall {wall * 1e3:.1f} ms (profiler on), device "
            f"busy {busy * 1e3:.1f} ms = {busy / wall:.1%}, idle {1 - busy / wall:.1%}")
        for e in sorted(rows, key=dev_us, reverse=True)[:6]:
            log(f"    {dev_us(e) / 1e3:9.2f} ms  x{e.count:<5d} {e.key[:90]}")


# ---------------------------------------------------------------------------
# phase 3: the port against itself
# ---------------------------------------------------------------------------

def phase_self_checks(model, prompts):
    log("phase 3: port self-checks")
    st = model.state
    tokens = torch.from_numpy(prompts).cuda()
    with torch.inference_mode():
        cold_logits, cold = st.prefill(tokens)
        _, part = st.prefill(tokens[:, :1024])
        res_logits, res = st.resume(tokens[:, 1024:], part, 1024)
    torch.cuda.synchronize()
    same = torch.equal(cold_logits, res_logits) and all(
        a.pos == b.pos and all(torch.equal(x, y) for x, y in zip(a[:4], b[:4]))
        for a, b in zip(cold, res))
    log(f"  prefill 1024 + resume 1016 == cold prefill 2040, bit for bit "
        f"(logits and all {len(cold)} layer caches): {same}")
    if not same:
        raise AssertionError("resumed prefill differs from the cold prefill")

    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, size=(2, 2048))).cuda()
    with torch.inference_mode():
        pc.polysketch_causal_cuda.launches = 0
        got, _ = model.lm(x, mode="train")
        launches = pc.polysketch_causal_cuda.launches
        plain = functools.partial(ops.polysketch_attention, impl="torch")
        with mock.patch.object(ops, "polysketch_attention", plain):
            want, _ = model.lm(x, mode="train")
    torch.cuda.synchronize()
    log(f"  train forward B=2 S=2048: B1 launches {launches} "
        f"(one per layer: {model.cfg.n_layers}); plain run: "
        f"{pc.polysketch_causal_cuda.launches - launches}")
    if launches != model.cfg.n_layers or pc.polysketch_causal_cuda.launches != launches:
        raise AssertionError("the train forward did not run B1 once per layer, "
                             "or the plain run launched it")
    rel = err(got, want) / want.abs().max().item()
    check("train forward B=2 S=2048 full width: kernel vs plain (rel. logits)",
          rel, F32_TOL)
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite train logits")

    cfg = get_config("gpt2s-polysketch", smoke=True)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 13))
    on_card = generate(build_model(cfg, device="cuda", seed=3), prompt, 8)
    on_cpu = generate(build_model(cfg, device="cpu", seed=3), prompt, 8)
    same = torch.equal(on_card.tokens.cpu(), on_cpu.tokens)
    check("SMOKE generate logits, card (kernel) vs CPU (plain)",
          err(on_card.logits_last.cpu(), on_cpu.logits_last), F32_TOL)
    log(f"  SMOKE greedy tokens (13-token prompt, 8 steps, crosses a fold) equal "
        f"on card and CPU: {same}")
    if not same:
        raise AssertionError("SMOKE greedy tokens differ between card and CPU")


def phase_serve_poly(model, prompts):
    """gpt2s-poly4 served as phase 2 serves polysketch: B2 launched once
    per layer by the one prefill call; decode timed with and without the
    KV cache's copy per step."""
    cfg = model.cfg
    steps, max_len = 16, prompts.shape[1] + 16
    log(f"phase 2: {cfg.name} full width, greedy generate, 4 x ({prompts.shape[1]} + "
        f"{steps}), KV cache of {max_len}")
    gen = lambda n_new: generate(model, prompts, n_new, max_len=max_len)  # noqa: E731
    generate(model, prompts[:, :64], 2)            # warm-up (allocator, cuBLAS)
    zero_counts()
    res, dt = timed(lambda: gen(steps))
    run_counts = counts()
    launches = run_counts["poly_flash"]
    toks = res.tokens.cpu().numpy()
    if toks.shape != (4, steps) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"bad tokens {toks.shape} [{toks.min()}, {toks.max()}]")
    if not torch.isfinite(res.logits_last).all():
        raise AssertionError("non-finite logits")
    log(f"  layers {cfg.n_layers} x d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.resolved_head_dim}, exact polynomial attention p={cfg.poly_degree}")
    log(f"  generate: {dt * 1e3:.1f} ms for 4 x {steps} tokens; B2 launches in the "
        f"run: {launches} (all kernels: {run_counts}; expected one per layer, "
        f"{cfg.n_layers})")
    if launches != cfg.n_layers or run_counts["polysketch_causal"] or run_counts["lt_mult"]:
        raise AssertionError("the poly4 generate did not launch B2 exactly once per "
                             "layer, or launched another kernel")
    _, t_pre = timed(lambda: gen(0))
    _, t_all = timed(lambda: gen(steps))
    log(f"  prefill (generate, 0 new tokens): {t_pre * 1e3:.1f} ms; decode "
        f"{(t_all - t_pre) * 1e3 / steps:.2f} ms/token-step; {4 * steps / t_all:.1f} "
        f"generated tok/s ({4 * (prompts.shape[1] + steps) / t_all:.0f} tok/s prompt "
        f"included)")
    decode_copy_cost(model, prompts, steps, max_len)
    for i, row in enumerate(toks):
        log(f"  req{i}: {' '.join(map(str, row.tolist()))}")
    profile_generate(model, prompts)
    return launches


def decode_copy_cost(model, prompts, steps, max_len):
    """What the KV cache's copy per decode step (caches are values) costs:
    16 decode steps from one prefill, timed with the copy and with the
    buffers written in place, in turns; and the device time of the copies
    alone (both buffers of every layer)."""
    st = model.state
    tokens = torch.from_numpy(prompts).cuda()
    s0 = prompts.shape[1]
    with torch.inference_mode():
        last, cache = st.prefill(tokens, max_len=max_len)
        tok = torch.argmax(last, dim=-1)[:, None]

        def run():
            c = cache
            for i in range(steps):
                _, c = st.decode_step(tok, s0 + i, c)
        in_place = lambda: mock.patch.object(dec, "_writable", lambda x: x)  # noqa: E731
        ms = {"copy": [], "in place": []}
        for label in ("copy", "in place", "in place", "copy", "copy", "in place"):
            if label == "copy":
                dt = timed(run)[1]
            else:
                with in_place():
                    dt = timed(run)[1]
            ms[label].append(dt * 1e3 / steps)
        copy_ms = event_ms(lambda: [dec._writable(x) for c in cache for x in (c.k, c.v)])
    med = {k: float(np.median(v)) for k, v in ms.items()}
    log(f"  decode step, KV cache copied (as shipped): median {med['copy']:.2f} ms "
        f"{[round(x, 2) for x in ms['copy']]}; written in place: median "
        f"{med['in place']:.2f} ms {[round(x, 2) for x in ms['in place']]} "
        f"(16 steps a run, host clock with sync, runs in turns); difference "
        f"{med['copy'] - med['in place']:.2f} ms/step")
    nbytes = sum(x.numel() * x.element_size() for c in cache for x in (c.k, c.v))
    log(f"  device time of the copies alone: {copy_ms:.3f} ms/step "
        f"({2 * nbytes / 1e6:.0f} MB read and written, CUDA events)")


def phase_poly_self_checks(model, prompts):
    log("phase 3: gpt2s-poly4 self-checks")
    cfg = model.cfg
    plain = mock.patch.object(ops, "poly_attention",
                              functools.partial(ops.poly_attention, impl="torch"))
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 2048))).cuda()
    with torch.inference_mode():
        zero_counts()
        got, _ = model.lm(x, mode="train")
        launches = pf.poly_flash_cuda.launches
        with plain:
            want, _ = model.lm(x, mode="train")
    torch.cuda.synchronize()
    log(f"  train forward B=2 S=2048: B2 launches {launches} (one per layer: "
        f"{cfg.n_layers}); plain run: {pf.poly_flash_cuda.launches - launches}")
    if launches != cfg.n_layers or pf.poly_flash_cuda.launches != launches:
        raise AssertionError("the train forward did not run B2 once per layer, "
                             "or the plain run launched it")
    check("train forward B=2 S=2048 full width: kernel vs plain (rel. logits)",
          err(got, want) / want.abs().max().item(), F32_TOL)
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite train logits")

    tokens = torch.from_numpy(prompts).cuda()
    max_len = prompts.shape[1] + 16
    with torch.inference_mode():
        got, _ = model.state.prefill(tokens, max_len=max_len)
        with plain:
            want, _ = model.state.prefill(tokens, max_len=max_len)
    torch.cuda.synchronize()
    check(f"prefill 4 x {prompts.shape[1]}: last-position logits, kernel vs plain (rel.)",
          err(got, want) / want.abs().max().item(), F32_TOL)

    for degree in (4, 8):
        smoke = get_config("gpt2s-polysketch", smoke=True, attention="polynomial",
                           poly_degree=degree)
        prompt = np.random.default_rng(2).integers(0, smoke.vocab_size, size=(2, 13))
        on_card = generate(build_model(smoke, device="cuda", seed=3), prompt, 8)
        on_cpu = generate(build_model(smoke, device="cpu", seed=3), prompt, 8)
        same = torch.equal(on_card.tokens.cpu(), on_cpu.tokens)
        check(f"SMOKE-polynomial p={degree} generate logits, card (kernel) vs CPU (plain)",
              err(on_card.logits_last.cpu(), on_cpu.logits_last), F32_TOL)
        log(f"  SMOKE-polynomial p={degree} greedy tokens (13-token prompt, 8 steps) "
            f"equal on card and CPU: {same}")
        if not same:
            raise AssertionError("SMOKE-polynomial greedy tokens differ between card "
                                 "and CPU")


def phase_lt_mult_path():
    """B3's path: its public entry point ops.lt_mult, called as a user (or
    benchmarks/kernel_bench.py) calls it, at the benchmark's shapes."""
    log("phase 2: B3's path, ops.lt_mult at kernel_bench's shapes "
        "(bh 4, m 32, k 64, block 256, n 2048 and 16384)")
    inputs = [lt_bench_inputs(n) for n in (2048, 16384)]
    zero_counts()
    outs = [ops.lt_mult(a, b, c, block_size=LT_BENCH["blk"]) for a, b, c in inputs]
    torch.cuda.synchronize()
    run_counts = counts()
    log(f"  launches in the run: {run_counts}")
    if run_counts["lt_mult"] != len(inputs):
        raise AssertionError("ops.lt_mult did not launch B3 once per call")
    for (_, _, c), out in zip(inputs, outs):
        if out.shape != c.shape or not torch.isfinite(out).all():
            raise AssertionError(f"bad lt_mult output {tuple(out.shape)}")
    return run_counts["lt_mult"]


# ---------------------------------------------------------------------------
# phase 4: kernel time at the slice's shape
# ---------------------------------------------------------------------------

def event_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def b1_ops(bh, n, r, h, b, degree):
    """B1's operations as the algorithm needs them (masked pairs not
    counted), as (products, rest). Products: the diagonal's Q K^T and W V
    (4h a pair), the cross term Phi(qm) [Zv | Zd] (2r^2 (h + 1) a row), the
    fold Km^T [Km (x) V | Km] (2br^2 (h + 1) a block). Rest: scale, power
    and row sum a pair; the cross term's elementwise work a row; the
    product km (x) v and the prefix a block."""
    t = n // b
    pairs = t * b * (b + 1) // 2
    prod = (pairs * 4 * h + n * (2 * r * r * h + 2 * r * r)
            + t * (2 * b * r * r * h + 2 * b * r * r))
    rest = (pairs * (2 + pow_muls(degree)) + n * (2 * r * h + 2 * r + h)
            + t * b * r * h + t * (r * r * h + r * r))
    return bh * prod, bh * rest


def b1_bound(bh, n, r, h, b, degree, itemsize=4):
    """B1's bounds on an H100: bytes are each input read once (z0 included:
    the wrapper passes zeros when none is given) and each output written
    once, the returned state included."""
    state = bh * (r * r * h + r * r) * 4
    nbytes = bh * n * (2 * r + 3 * h) * itemsize + bh * n * h * itemsize + 2 * state
    return bounds(*b1_ops(bh, n, r, h, b, degree), nbytes)


class Bounds(NamedTuple):
    tc_ms: float      # the tensor-core route (3xTF32)
    tc_by: str        # 'bytes' | 'operations'
    fma_ms: float     # every operation on the f32 FMA pipes
    fma_by: str
    flops: int        # products + rest
    nbytes: int


def bounds(prod, rest, nbytes) -> Bounds:
    """Least times on an H100 (ms), each the larger of operations and bytes
    at the HBM rate: on the tensor-core route, three TF32 products per f32
    product at the TF32 peak plus the rest at the f32 peak; on the FMA
    route, all operations at the f32 peak."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_tc = 3 * prod / H100_TF32_FLOPS + rest / H100_F32_FLOPS
    t_fma = (prod + rest) / H100_F32_FLOPS
    by = lambda t_ops: "operations" if t_ops >= t_bytes else "bytes"  # noqa: E731
    return Bounds(max(t_tc, t_bytes) * 1e3, by(t_tc), max(t_fma, t_bytes) * 1e3,
                  by(t_fma), prod + rest, nbytes)


def pow_muls(degree):
    """Multiplies of x^p by repeated squaring."""
    return max(degree.bit_length() - 1 + bin(degree).count("1") - 1, 0)


def phase_timing():
    """B1 at the slice's shape and at the two calls each layer of a
    2040-token prefill makes: n = b = 1024 returning its state, then
    n = b = 1016 seeded with it."""
    log("phase 4: B1 time at the slice's shape and the prefill's call shapes "
        "(CUDA events, warmed up)")
    qm, km, q, k, v = (x.reshape(48, 2048, -1).contiguous() for x in slice_inputs())
    head = [x[:, :1024].contiguous() for x in (qm, km, q, k, v)]
    tail = [x[:, 1024:2040].contiguous() for x in (qm, km, q, k, v)]
    kw = dict(degree=4, scale=1.0 / 64, return_state=True)
    launches = pc.polysketch_causal_cuda.launches
    _, zv0, zd0 = pc.polysketch_causal_cuda(*head, block_size=1024, **kw)
    out = {}
    for name, xs, n, z0 in (("n 2048, b 1024", (qm, km, q, k, v), 2048, ()),
                            ("prefill block n = b = 1024", head, 1024, ()),
                            ("prefill tail n = b = 1016 + z0", tail, 1016, (zv0, zd0))):
        b = 1024 if n == 2048 else n
        run = lambda: pc.polysketch_causal_cuda(*xs, *z0, block_size=b, **kw)  # noqa: E731
        ms = event_ms(run)
        plain_ms = event_ms(lambda: pc.polysketch_causal_torch(*xs, *z0, block_size=b, **kw))
        ms2 = event_ms(run)
        bd = b1_bound(48, n, 32, 64, b, 4)
        out[n] = (min(ms, ms2), plain_ms, bd)
        log(f"  B1 {name} bh=48 r=32 h=64: kernel {min(ms, ms2):.3f} ms (runs {ms:.3f}, "
            f"{ms2:.3f}; the plain version ran between them), plain PyTorch "
            f"{plain_ms:.3f} ms; bound {bd.tc_ms:.3f} ms by {bd.tc_by} on the tensor cores "
            f"({bd.flops / 1e9:.1f} GFLOP, products in 3xTF32 at 495 TFLOP/s, the rest at "
            f"67; {bd.nbytes / 1e6:.1f} MB at 3.35 TB/s), {bd.tc_ms / min(ms, ms2):.1%} of "
            f"it; f32-FMA bound {bd.fma_ms:.3f} ms, {bd.fma_ms / min(ms, ms2):.1%} of it; "
            f"library call: {NO_LIBRARY}")
    pc.polysketch_causal_cuda.launches = launches   # timing launches do not count
    return out


def b2_bound(bh, n, h, degree, itemsize=4):
    """Causal B2 (n == t): per pair the products Q K^T and W V (4h), the
    scale, the power and the row sum; per row the normalisation. Bytes:
    q, k, v read once, out written once."""
    pairs = bh * n * (n + 1) // 2
    prod = pairs * 4 * h
    rest = pairs * (2 + pow_muls(degree)) + bh * n * (h + 2)
    return bounds(prod, rest, 4 * bh * n * h * itemsize)


def b3_bound(bh, n, m, k, b, itemsize=4):
    """B3 as the block algorithm needs it. Products: each block's triangle
    (2m for a score, 2k for its row of W C), the fold B^T C and the cross
    term A Z (2mk a row each); the rest: the prefix's adds over blocks.
    Bytes: A, B, C read once, O written once."""
    t = n // b
    pairs = t * b * (b + 1) // 2
    prod = bh * (pairs * (2 * m + 2 * k) + 4 * n * m * k)
    return bounds(prod, bh * t * m * k, bh * n * (2 * m + 2 * k) * itemsize)


def phase_timing_poly_lt():
    """B2 and B3 timed as phase 4 times B1: kernel, plain, kernel."""
    log("phase 4: B2 and B3 times at their paths' shapes (CUDA events, warmed up)")
    before = counts()
    out = {"poly_flash": {}, "lt_mult": {}}
    for n in (2040, 2048):
        q, k, v = (x.reshape(48, n, 64).contiguous() for x in poly_slice_inputs(n))
        kw = dict(degree=4, scale=1.0 / 64)
        ms = event_ms(lambda: pf.poly_flash_cuda(q, k, v, **kw))
        plain_ms = event_ms(lambda: pf.poly_flash_torch(q, k, v, **kw))
        ms2 = event_ms(lambda: pf.poly_flash_cuda(q, k, v, **kw))
        bd = b2_bound(48, n, 64, 4)
        out["poly_flash"][n] = (min(ms, ms2), plain_ms, bd)
        log(f"  B2 bh=48 n={n} h=64 p=4: kernel {min(ms, ms2):.3f} ms (runs {ms:.3f}, "
            f"{ms2:.3f}), plain PyTorch {plain_ms:.3f} ms; bound {bd.tc_ms:.3f} ms by "
            f"{bd.tc_by} on the tensor cores ({bd.flops / 1e9:.1f} GFLOP, "
            f"{bd.nbytes / 1e6:.1f} MB), {bd.tc_ms / min(ms, ms2):.1%} of it; f32-FMA bound "
            f"{bd.fma_ms:.3f} ms, {bd.fma_ms / min(ms, ms2):.1%} of it; library call: "
            f"{NO_LIBRARY}")
    for n in (2048, 16384):
        a, b, c = lt_bench_inputs(n)
        kw = dict(block_size=LT_BENCH["blk"])
        ms = event_ms(lambda: lt.lt_mult_cuda(a, b, c, **kw))
        plain_ms = event_ms(lambda: lt.lt_mult_torch(a, b, c, **kw))
        ms2 = event_ms(lambda: lt.lt_mult_cuda(a, b, c, **kw))
        bd = b3_bound(4, n, 32, 64, LT_BENCH["blk"])
        out["lt_mult"][n] = (min(ms, ms2), plain_ms, bd)
        log(f"  B3 bh=4 n={n} m=32 k=64 block=256: kernel {min(ms, ms2):.4f} ms (runs "
            f"{ms:.4f}, {ms2:.4f}), plain PyTorch {plain_ms:.4f} ms; bound {bd.tc_ms:.4f} "
            f"ms by {bd.tc_by} on the tensor cores ({bd.flops / 1e9:.3f} GFLOP, "
            f"{bd.nbytes / 1e6:.1f} MB), {bd.tc_ms / min(ms, ms2):.1%} of it; f32-FMA "
            f"bound {bd.fma_ms:.4f} ms by {bd.fma_by}, {bd.fma_ms / min(ms, ms2):.1%} of "
            f"it; library call: {NO_LIBRARY}")
    for name, fn in KERNELS.items():   # timing launches do not count
        fn.launches = before[name]
    return out


# (pass, a substring of its kernels' names)
LT_PASSES = (("fold", "fold"), ("prefix", "prefix"), ("outputs", "output"))


def lt_mult_breakdown(fn, n, passes=LT_PASSES, calls=20, host_calls=100):
    """B3's wrapper `fn` at kernel_bench's shape: device time per pass per
    call (ms) from torch.profiler over `calls` calls, each kernel counted
    under the first pass in `passes` whose key its name holds; and the
    host's time per call (ms), wall clock over `host_calls` calls issued
    without a sync, beside the CUDA events' time over the same calls."""
    from torch.profiler import ProfilerActivity, profile
    a, b, c = lt_bench_inputs(n)
    run = lambda: fn(a, b, c, block_size=LT_BENCH["blk"])  # noqa: E731
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    per_pass = {name: 0.0 for name, _ in passes}
    for e in device_rows(prof):
        name = next((p for p, key in passes if key in e.key), None)
        if name is None:
            raise AssertionError(f"lt_mult profile: unexpected device kernel {e.key!r}")
        per_pass[name] += dev_us(e) / 1e3 / calls
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(host_calls):
        run()
    host_ms = (time.perf_counter() - t0) * 1e3 / host_calls
    end.record()
    torch.cuda.synchronize()
    return per_pass, host_ms, start.elapsed_time(end) / host_calls


def phase_lt_mult_breakdown():
    log("phase 4: B3 per pass (torch.profiler device time per call) and host time per "
        "call (wall clock over 100 calls without sync, against CUDA events)")
    before = lt.lt_mult_cuda.launches
    for n in (2048, 16384):
        passes, host_ms, event_ms_ = lt_mult_breakdown(lt.lt_mult_cuda, n)
        log(f"  B3 n={n}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in passes.items())
            + f"; device sum {sum(passes.values()):.4f} ms; host {host_ms:.4f} ms per "
            f"call, CUDA events {event_ms_:.4f} ms per call")
    lt.lt_mult_cuda.launches = before   # timing launches do not count


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s, nvcc per source: "
        + ", ".join(f"{n} {b.seconds:.1f} s" for n, b in libs.items()))
    for name, built in libs.items():
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    max_err = phase_kernel_grid()
    b2_err = phase_poly_flash_grid()
    b3_err = phase_lt_mult_grid()
    phase_tolerance_study()
    model = build_model(get_config("gpt2s-polysketch"), device="cuda", seed=0)
    launches, prompts = phase_serve(model)
    phase_self_checks(model, prompts)
    del model
    torch.cuda.empty_cache()
    poly = build_model(GPT2_SMALL_POLY4, device="cuda", seed=0)
    b2_launches = phase_serve_poly(poly, prompts)
    phase_poly_self_checks(poly, prompts)
    del poly
    torch.cuda.empty_cache()
    b3_launches = phase_lt_mult_path()
    b1_times = phase_timing()
    times = phase_timing_poly_lt()
    phase_lt_mult_breakdown()

    def row(name, replaces, launches, max_abs_err, timing):
        t_ms, t_plain, bd = timing
        return {"name": name, "route": "cuda", "status": "ok",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": max_abs_err, "ms": t_ms, "plain_ms": t_plain,
                "bound_ms": bd.tc_ms, "bound_by": bd.tc_by, "bound_fma_ms": bd.fma_ms,
                "library_ms": None}

    log(card)                     # as nvidia-smi prints it: name, power limit
    log(json.dumps({"kernels": [
        row("polysketch_causal", "src/repro/kernels/polysketch_causal.py:118",
            launches, max_err, b1_times[2048]),
        row("poly_flash", "src/repro/kernels/poly_flash.py:59", b2_launches, b2_err,
            times["poly_flash"][2040]),
        row("lt_mult", "src/repro/kernels/lt_mult.py:45", b3_launches, b3_err,
            times["lt_mult"][16384])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
