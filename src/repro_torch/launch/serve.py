"""Greedy serving CLI of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2s-polysketch
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

Builds the model from a seeded init, makes `--requests` prompts of
`--prompt-len` tokens from `--seed` with numpy, runs them as one batch
through `generate`, and prints each request's tokens and the throughput.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.model_zoo import build_model
from repro_torch.serve.engine import generate


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gpt2s-polysketch")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (for the CPU)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=2040)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=args.device, seed=args.seed)
    dev = model.device
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(args.requests, args.prompt_len))
    _sync(dev)
    t0 = time.perf_counter()
    res = generate(model, prompts, args.gen)
    _sync(dev)
    dt = time.perf_counter() - t0
    toks = res.tokens.cpu().numpy()
    for i, row in enumerate(toks):
        print(f"req{i}: len={args.prompt_len} +{len(row)} tok: "
              f"{' '.join(map(str, row.tolist()))}")
    n_out = toks.size
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{cfg.name} on {name}: {args.requests} requests x "
          f"{args.prompt_len}+{args.gen} tokens in {dt:.3f} s "
          f"({n_out / dt:.1f} generated tok/s, prefill included)")
    if not np.isfinite(res.logits_last.float().cpu().numpy()).all():
        raise SystemExit("non-finite logits")


if __name__ == "__main__":
    main()
