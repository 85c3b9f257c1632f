"""B3 (lt_mult) of this checkout beside B3 of another checkout, on one card,
in turns, at kernel_bench's shape (bh 4, m 32, k 64, b 256; n 2048 and
16384, f32).

    python3 scripts/port_lt_mult_ab.py --other DIR [--order NAME,NAME,...]

"this" is this checkout's `lt_mult_cuda`; "other" is DIR's, loaded from
DIR's `kernels/lt_mult.py` and `kernels/build.py`, which build DIR's
csrc/lt_mult.cu into DIR's build/. For each name in --order (default
"this,other,other,this") it holds the result against lt_mult_torch
(max|err| / max|out|, two runs bit for bit), then prints
chip_smoke.lt_mult_breakdown's device time per pass and host time per
call, and the CUDA-event time (best of two runs of 20 calls); then whether
the two checkouts' outputs are the same bits. Prints the card's name and
power limit first and last.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from port_ab import other_module  # noqa: E402
from repro_torch.kernels import lt_mult as lt  # noqa: E402

# kernels of each pass, by a substring of their names (B3 before its
# tensor-core form named its fold block_state_kernel)
PASSES = cs.LT_PASSES + (("fold", "block_state"),)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, help="a checkout of another commit")
    ap.add_argument("--order", default="this,other,other,this", help="names in turn")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_lt_mult_ab: no CUDA device available", file=sys.stderr)
        return 1
    cs.log(cs.card_line())
    fns = {"this": lt.lt_mult_cuda, "other": other_module(args.other, "lt_mult").lt_mult_cuda}
    inputs = {n: cs.lt_bench_inputs(n) for n in (2048, 16384)}
    blk = cs.LT_BENCH["blk"]
    want = {n: lt.lt_mult_torch(*x, block_size=blk) for n, x in inputs.items()}
    for name in args.order.split(","):
        fn = fns[name]
        line = []
        for n, (a, b, c) in inputs.items():
            run = lambda: fn(a, b, c, block_size=blk)  # noqa: E731
            got, again = run(), run()
            torch.cuda.synchronize()
            rel = cs.err(got, want[n]) / want[n].abs().max().item()
            same = torch.equal(got, again)
            passes, host_ms, _ = cs.lt_mult_breakdown(fn, n, PASSES)
            ms = min(cs.event_ms(run), cs.event_ms(run))
            line.append(f"n={n}: {ms:.4f} ms [" + " ".join(f"{k} {v:.4f}" for k, v in
                                                          passes.items())
                        + f"] host {host_ms:.4f} rel.err {rel:.2e} bit-stable {same}")
        cs.log(f"{name:8s} " + " | ".join(line))
    outs = {name: {n: fns[name](a, b, c, block_size=blk) for n, (a, b, c) in inputs.items()}
            for name in fns}
    torch.cuda.synchronize()
    equal = all(torch.equal(outs["this"][n], outs["other"][n]) for n in inputs)
    cs.log(f"outputs of this and other equal bit for bit: {equal}")
    cs.log(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
