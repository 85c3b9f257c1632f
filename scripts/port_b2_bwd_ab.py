"""B2's backward of this checkout beside B2's backward of another checkout,
on one card, in turns, at the training shape (bh 24, n 4096, h 64, degree
4, f32).

    python3 scripts/port_b2_bwd_ab.py --other DIR [--order NAME,NAME,...]

"this" is this checkout's `poly_flash_backward_cuda`; "other" is DIR's,
loaded from DIR's `kernels/poly_flash.py` and `kernels/build.py`, which
build DIR's csrc/poly_flash_bwd.cu into DIR's build/. Both take the same
inputs: chip_smoke.b2_grad_inputs through this checkout's forward (its
output and D = 1 + den). For each name in --order (default
"this,other,other,this") it holds the gradients against
poly_flash_backward_torch (the worst max|err| as a share of each
gradient's max|.|, and two calls bit for bit), then prints the device time
per kernel (chip_smoke.profile_passes over 20 calls) and the CUDA-event
time (best of two runs of 20 calls), as a share of the bound
(chip_smoke.b2_bwd_bound). Then each name's gradients against a float64
reference, per gradient. Prints the card's name and power limit first and
last.
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
from repro_torch.kernels import poly_flash as pf  # noqa: E402

# kernels of each pass, by a substring of their names: this design's, then
# the names of the design before it (its key and query kernels)
PASSES = cs.B2_BWD_PASSES + (("key tiles (dk, dv)", "poly_flash_bwd_key"),
                             ("query tiles (dq)", "poly_flash_bwd_query"))
KW = dict(degree=4, scale=1.0 / 64)
BH, N, H = 24, 4096, 64


def float64_grads(dout, q, k, v, degree, scale, block=512):
    """dq, dk, dv of causal B2 in float64: autograd through the forward
    taken one query block at a time."""
    q, k, v = (x.double().requires_grad_() for x in (q, k, v))
    n = q.shape[1]
    outs = []
    for q0 in range(0, n, block):
        q1 = min(n, q0 + block)
        w = (q[:, q0:q1] @ k[:, :q1].transpose(1, 2) * scale) ** degree
        above = torch.ones(q1 - q0, q1, dtype=torch.bool, device=q.device).triu(q0 + 1)
        w = w.masked_fill(above, 0.0)
        outs.append(w @ v[:, :q1] / (1.0 + w.sum(-1, keepdim=True)))
    torch.autograd.backward(torch.cat(outs, 1), dout.double())
    return q.grad, k.grad, v.grad


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, help="a checkout of another commit")
    ap.add_argument("--order", default="this,other,other,this", help="names in turn")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_b2_bwd_ab: no CUDA device available", file=sys.stderr)
        return 1
    cs.log(cs.card_line())
    other = other_module(args.other, "poly_flash")
    xs, dout = cs.b2_grad_inputs(16, 2, 12, 12, N, H, KW["degree"])
    q, k, v, dout = (x.reshape(BH, N, H).contiguous() for x in (*xs, dout))
    out, den = pf.poly_flash_cuda(q, k, v, return_den=True, **KW)
    want = pf.poly_flash_backward_torch(dout, q, k, v, out, den, **KW)
    fns = {"this": pf.poly_flash_backward_cuda, "other": other.poly_flash_backward_cuda}
    turns = backward_turns(args.order, fns, lambda fn: fn(dout, q, k, v, out, den, **KW), want,
                           PASSES)
    bd = cs.b2_bwd_bound(BH, N, H, KW["degree"])
    for name, runs in turns.items():
        best = min(ms for ms, *_ in runs)
        cs.log(f"{name:6s} best {best:.3f} ms, {bd.tc_ms / best:.1%} of the {bd.tc_ms:.3f} ms "
               f"bound ({bd.tc_by} on the tensor cores)")
    ref = float64_grads(dout, q, k, v, **KW)
    for name, fn in [("plain", pf.poly_flash_backward_torch)] + list(fns.items()):
        got = fn(dout, q, k, v, out, den, **KW)
        errs = [((a.double() - b).abs().max() / b.abs().max()).item() for a, b in zip(got, ref)]
        cs.log(f"{name:6s} against float64, max|err| / max|.|: dq {errs[0]:.2e} dk {errs[1]:.2e} "
               f"dv {errs[2]:.2e}")
    cs.log(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
