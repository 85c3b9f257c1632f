"""B1's backward of this checkout beside B1's backward of another checkout,
on one card, in turns, at the training shape (bh 24, n 4096, r 32, h 64,
b 1024, degree 4, local_exact, f32).

    python3 scripts/port_b1_bwd_ab.py --other DIR [--order NAME,NAME,...]

"this" is this checkout's `polysketch_causal_backward_cuda`; "other" is
DIR's, loaded from DIR's `kernels/polysketch_causal.py` and
`kernels/build.py`, which build DIR's csrc/polysketch_causal_bwd.cu into
DIR's build/. Both take the same inputs: chip_smoke.train_attention_inputs
through this checkout's forward (which saves Z_l and 1 + den). For each
name in --order (default "this,other,other,this") it holds the gradients
against polysketch_causal_backward_torch (the worst max|err| as a share of
each gradient's max|.|, and two calls bit for bit), then prints the device
time per pass (chip_smoke.profile_passes over 20 calls) and the CUDA-event
time (best of two runs of 20 calls). It also checks that DIR's forward
gives this checkout's outputs and saved state bit for bit. Prints the
card's name and power limit first and last.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from port_ab import backward_turns, other_module  # noqa: E402
from repro_torch.kernels import polysketch_causal as pc  # noqa: E402

# kernels of each pass, by a substring of their names: this design's, then
# the names the backward's kernels had before it (fold and suffix were the
# forward's own kernels then)
PASSES = cs.B1_BWD_PASSES + (("prep", "prep_kernel"), ("fold", "fold_kernel"),
                             ("suffix", "prefix_kernel"), ("query tiles", "query_kernel"),
                             ("key tiles", "key_kernel"))
KW = dict(degree=4, scale=1.0 / 64, block_size=1024)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, help="a checkout of another commit")
    ap.add_argument("--order", default="this,other,other,this", help="names in turn")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_b1_bwd_ab: no CUDA device available", file=sys.stderr)
        return 1
    cs.log(cs.card_line())
    other = other_module(args.other, "polysketch_causal")
    xs, dout = cs.train_attention_inputs()
    flat = [x.reshape(24, 4096, -1).contiguous() for x in xs]
    dout = dout.reshape(24, 4096, -1).contiguous()
    out, _, _, saved = pc.polysketch_causal_cuda(*flat, return_saved=True, **KW)
    o_out, _, _, o_saved = other.polysketch_causal_cuda(*flat, return_saved=True, **KW)
    torch.cuda.synchronize()
    same_fwd = torch.equal(out, o_out) and all(torch.equal(a, b) for a, b in zip(saved, o_saved))
    cs.log(f"forward (output, Z_l, 1 + den) of this and other equal bit for bit: {same_fwd}")
    want = pc.polysketch_causal_backward_torch(dout, *flat, out, saved, **KW)
    fns = {"this": pc.polysketch_causal_backward_cuda,
           "other": other.polysketch_causal_backward_cuda}
    backward_turns(args.order, fns, lambda fn: fn(dout, *flat, out, saved, **KW), want, PASSES)
    cs.log(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
