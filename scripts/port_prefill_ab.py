"""Time the PyTorch port's full-width prefills in one checkout of the repo.

    python3 scripts/port_prefill_ab.py [ROOT]

ROOT (default: this checkout) is the root of a checkout whose
`src/repro_torch` is imported. Its CUDA kernels are built into ROOT's own
`build/`. gpt2s-polysketch and gpt2s-poly4 each prefill 4 prompts of 2040
tokens (`generate` with 0 new tokens, random weights and tokens from
seed 0, after a warm-up). Each time is the host clock around a
synchronised call; the script prints the median of 5 and the runs, one
JSON line per model. To compare two commits on one card, run this once
per checkout in one command, in turns: A, B, B, A. Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.gpt2_paper import GPT2_SMALL_POLY4  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve.engine import generate  # noqa: E402

RUNS = 5


def prefill_ms(cfg, prompts, max_len=None):
    model = build_model(cfg, device="cuda", seed=0)
    kw = {} if max_len is None else {"max_len": max_len}
    generate(model, prompts[:, :64], 2)            # warm-up (allocator, cuBLAS)
    generate(model, prompts, 0, **kw)
    times = []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(model, prompts, 0, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    del model
    torch.cuda.empty_cache()
    return times


def main():
    if not torch.cuda.is_available():
        print("port_prefill_ab: no CUDA device available", file=sys.stderr)
        return 1
    cfg = get_config("gpt2s-polysketch")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(4, 2040))
    for name, c, max_len in (("gpt2s-polysketch", cfg, None),
                             ("gpt2s-poly4", GPT2_SMALL_POLY4, prompts.shape[1] + 16)):
        times = prefill_ms(c, prompts, max_len)
        print(json.dumps({"root": ROOT, "model": name, "prefill_ms": statistics.median(times),
                          "runs_ms": [round(t, 2) for t in times],
                          "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
