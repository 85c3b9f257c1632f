"""What the port's A/B scripts share: loading another checkout's kernel
module so that it builds and launches that checkout's sources, and the
turns of a backward A/B (scripts/port_b1_bwd_ab.py, port_b2_bwd_ab.py).
"""
from __future__ import annotations

import importlib.util
import os

import torch

import chip_smoke as cs


def load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def other_module(root: str, name: str):
    """DIR's kernels/<name>.py, launching libraries built from DIR's sources
    into DIR's build/."""
    kernels = os.path.join(root, "src", "repro_torch", "kernels")
    module = load(os.path.join(kernels, f"{name}.py"), f"other_{name}")
    # the module imported this checkout's build; its library loaders read
    # `build` at call time, so DIR's own build module takes its place
    module.build = load(os.path.join(kernels, "build.py"), "other_build")
    return module


def backward_turns(order: str, fns: dict, call, want, passes):
    """For each name in `order` (comma-separated keys of `fns`), run
    `call(fns[name])` (a backward call returning gradients): its worst
    gradient error against `want` as a share of each gradient's max|.|, two
    calls bit for bit, the device time per pass (chip_smoke.profile_passes
    over 20 calls) and the CUDA-event time (best of two runs of 20 calls).
    Logs a line a turn, then whether the names' gradients are the same bits;
    returns {name: [(ms, passes, rel, same), ...]}."""
    out, first = {}, {}
    for name in order.split(","):
        fn = fns[name]
        run = lambda: call(fn)  # noqa: E731
        got, again = run(), run()
        torch.cuda.synchronize()
        first.setdefault(name, got)
        rel = cs.grad_err(got, want)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        split = cs.profile_passes(run, passes)
        ms = min(cs.event_ms(run), cs.event_ms(run))
        text = " ".join(f"{k} {v:.3f}" for k, v in split.items() if v > 0)
        cs.log(f"{name:6s} {ms:.3f} ms [{text}; sum {sum(split.values()):.3f}] "
               f"grad rel.err {rel:.2e} bit-stable {same}")
        out.setdefault(name, []).append((ms, split, rel, same))
    names = list(first)
    equal = all(torch.equal(a, b) for other in names[1:]
                for a, b in zip(first[names[0]], first[other]))
    cs.log(f"gradients of {' and '.join(names)} equal bit for bit: {equal}")
    return out
