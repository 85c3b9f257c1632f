"""Time the forward kernels B1 (polysketch_causal) and B2 (poly_flash) of
this checkout against another checkout's, in turns, on one card.

    python3 scripts/port_fwd_ab.py --other DIR [--order this,other,other,this]

DIR is the root of another checkout (its kernels are built from its own
sources into DIR/build). Shapes: B1 at bh 48, n 2048, r 32, h 64, b 1024
(PERF.md section 6's), B2 at bh 48, n 2040, h 64, degree 4, causal; f32,
inputs from seed 11 scaled like the model's. Each turn logs the kernel's
CUDA-event time (best of two runs of 20 calls) and its output's max|err|
against the plain f32 version. Needs a CUDA card.
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--order", default="this,other,other,this")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_fwd_ab: no CUDA device available", file=sys.stderr)
        return 1
    cs.log(f"card: {cs.card_line()}")
    mods = {"this": (pc, pf),
            "other": (port_ab.other_module(args.other, "polysketch_causal"),
                      port_ab.other_module(args.other, "poly_flash"))}
    b1_in = [x.reshape(48, 2048, -1).contiguous() for x in cs.slice_inputs()]
    b2_in = [x[..., :2040, :].reshape(48, 2040, -1).contiguous() for x in cs.slice_inputs()[2:]]
    b1_kw = dict(degree=4, scale=1.0 / 64, block_size=1024)
    b2_kw = dict(degree=4, scale=1.0 / 64, causal=True)
    with torch.no_grad():
        b1_want = pc.polysketch_causal_torch(*b1_in, **b1_kw)
        b2_want = pf.poly_flash_torch(*b2_in, **b2_kw)
    for name in args.order.split(","):
        b1, b2 = mods[name]
        for label, run, want in (
                ("B1 bh 48 n 2048 h 64 b 1024", lambda: b1.polysketch_causal_cuda(*b1_in, **b1_kw),
                 b1_want),
                ("B2 bh 48 n 2040 h 64", lambda: b2.poly_flash_cuda(*b2_in, **b2_kw), b2_want)):
            e = cs.err(run(), want)
            ms = min(cs.event_ms(run), cs.event_ms(run))
            cs.log(f"{name:6s} {label}: {ms:.3f} ms, max|err| vs plain f32 {e:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
