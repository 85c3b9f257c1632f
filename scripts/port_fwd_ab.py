"""Time the forward kernels B1 (polysketch_causal) and B2 (poly_flash) of
this checkout against another checkout's, in turns, on one card.

    python3 scripts/port_fwd_ab.py --other DIR [--order this,other,other,this]

DIR is the root of another checkout (its kernels are built from its own
sources into DIR/build). Shapes, every one chip_smoke.py's phase 4 times:
  - B1 at bh 48, n 2048, r 32, h 64, b 1024 (the slice's shape), and the
    prefill's two calls, n = b = 1024 returning its state and n = b = 1016
    seeded with it;
  - B1 at the training shape (bh 24, n 4096, b 1024) and at the 32k shape
    (bh 12, n 32768, b 1024), saving Z_l and 1 + den as training does;
  - B1 at h 128 (bh 24, n 4096, r 32, b 256, starcoder2-3b's training
    shape), saving, in bf16 and in f32;
  - B2 at bh 48, n 2040, h 64 (serving) and at bh 12, n 32768 writing D
    (the 32k training shape); degree 4, causal.
f32 unless marked, inputs from chip_smoke.py's generators. Each turn logs
the kernel's CUDA-event time (best of two runs; 20 calls, 5 at 32k), its
share of the bound on the tensor cores (chip_smoke.b1_bound / b2_bound),
and its output's max|err| against the plain version in the same dtype.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import port_ab  # noqa: E402
from repro_torch.kernels import poly_flash as pf  # noqa: E402
from repro_torch.kernels import polysketch_causal as pc  # noqa: E402


def b1_cases():
    """(label, inputs, keyword arguments, bound, iterations) of every B1 shape."""
    slice_in = [x.reshape(48, 2048, -1).contiguous() for x in cs.slice_inputs()]
    head = [x[:, :1024].contiguous() for x in slice_in]
    tail = [x[:, 1024:2040].contiguous() for x in slice_in]
    kw = dict(degree=4, scale=1.0 / 64)
    _, zv0, zd0 = pc.polysketch_causal_torch(*head, block_size=1024, return_state=True, **kw)
    cases = [("B1 bh 48 n 2048 h 64 b 1024", slice_in, dict(block_size=1024, **kw),
              cs.b1_bound(48, 2048, 32, 64, 1024, 4), 20),
             ("B1 prefill n = b = 1024", head, dict(block_size=1024, return_state=True, **kw),
              cs.b1_bound(48, 1024, 32, 64, 1024, 4), 20),
             ("B1 prefill n = b = 1016 + z0", tail + [zv0, zd0],
              dict(block_size=1016, return_state=True, **kw),
              cs.b1_bound(48, 1016, 32, 64, 1016, 4), 20)]
    xs, _ = cs.train_attention_inputs()
    cases.append(("B1 training bh 24 n 4096 b 1024, saving",
                  [x.reshape(24, 4096, -1).contiguous() for x in xs],
                  dict(block_size=1024, return_saved=True, **kw),
                  cs.b1_bound(24, 4096, 32, 64, 1024, 4), 20))
    xs, _ = cs.long_kernel_inputs()
    cases.append((f"B1 32k bh 12 n {cs.LONG_TOKENS} b 1024, saving",
                  [x.reshape(12, cs.LONG_TOKENS, -1).contiguous() for x in xs],
                  dict(block_size=1024, return_saved=True, **kw),
                  cs.b1_bound(12, cs.LONG_TOKENS, 32, 64, 1024, 4), 5))
    for dt in (torch.bfloat16, torch.float32):
        rnd = cs.seeded(64)
        bh, n, r, h, b = 24, 4096, 32, 128, 256
        flat = [rnd(bh, n, r, scale=0.5, dtype=dt), rnd(bh, n, r, scale=0.5, dtype=dt)]
        flat += [rnd(bh, n, h, dtype=dt) for _ in range(3)]
        isz = 2 if dt == torch.bfloat16 else 4
        cases.append((f"B1 h 128 {str(dt)[6:]} bh 24 n 4096 b 256, saving", flat,
                      dict(degree=4, scale=1.0 / h, block_size=b, return_saved=True),
                      cs.b1_bound(bh, n, r, h, b, 4, itemsize=isz), 20))
    return cases


def b2_cases():
    q, k, v = (x.reshape(48, 2040, 64).contiguous() for x in cs.poly_slice_inputs(2040))
    kw = dict(degree=4, scale=1.0 / 64)
    cases = [("B2 bh 48 n 2040 h 64", [q, k, v], kw, cs.b2_bound(48, 2040, 64, 4), 20)]
    xs, _ = cs.b2_grad_inputs(32, 1, 12, 12, cs.LONG_TOKENS, 64, 4)
    cases.append((f"B2 32k bh 12 n {cs.LONG_TOKENS} h 64, writing D",
                   [x.reshape(12, cs.LONG_TOKENS, 64).contiguous() for x in xs],
                   dict(return_den=True, **kw), cs.b2_bound(12, cs.LONG_TOKENS, 64, 4), 5))
    return cases


def first(out):
    return out[0] if isinstance(out, tuple) else out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--order", default="this,other,other,this")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_fwd_ab: no CUDA device available", file=sys.stderr)
        return 1
    cs.log(f"card: {cs.card_line()}")
    mods = {"this": {"B1": pc.polysketch_causal_cuda, "B2": pf.poly_flash_cuda},
            "other": {"B1": port_ab.other_module(args.other,
                                                 "polysketch_causal").polysketch_causal_cuda,
                      "B2": port_ab.other_module(args.other, "poly_flash").poly_flash_cuda}}
    plain = {"B1": pc.polysketch_causal_torch, "B2": pf.poly_flash_torch}
    for kernel, cases in (("B1", b1_cases()), ("B2", b2_cases())):
        for label, xs, kw, bd, iters in cases:
            with torch.no_grad():
                want = first(plain[kernel](*xs, **kw))
            for name in args.order.split(","):
                fn = mods[name][kernel]
                run = lambda: fn(*xs, **kw)  # noqa: E731
                e = cs.err(first(run()).float(), want.float())
                ms = min(cs.event_ms(run, iters=iters), cs.event_ms(run, iters=iters))
                cs.log(f"{name:6s} {label}: {ms:.3f} ms, {bd.tc_ms / ms:.1%} of the TC bound "
                       f"{bd.tc_ms:.3f} ms, max|err| vs plain {e:.3e}")
            del want
        del cases
        torch.cuda.empty_cache()
    cs.log(f"card: {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
