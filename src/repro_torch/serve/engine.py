"""Greedy generation on the DecodeState protocol.

Port of ``generate`` in the JAX package's ``serve/engine.py``: prefill the
prompt into the constant-size polysketch cache, then decode one token at a
time. Greedy only for now; the continuous-batching engine is not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class GenerationResult(NamedTuple):
    tokens: torch.Tensor       # (B, steps)
    logits_last: torch.Tensor  # (B, V) logits after the last decode step


@torch.inference_mode()
def generate(model, prompt, steps: int, *, temperature: float = 0.0,
             max_len: int | None = None) -> GenerationResult:
    """Greedy decoding loop. prompt: (B, S0) ints (tensor or numpy).

    Token i is the argmax of the logits after token i-1 (the prefill's
    last position for i = 0), then fed back through decode_step at
    position S0 + i, exactly as the reference's greedy schedule.
    """
    if temperature > 0:
        raise NotImplementedError(
            "sampling is not ported: matching the reference's tokens needs "
            "JAX's threefry key schedule rebuilt in torch (ROADMAP A.9)")
    state = model.state
    dev = model.device
    if isinstance(prompt, np.ndarray):
        prompt = torch.from_numpy(prompt)
    prompt = prompt.to(device=dev, dtype=torch.long)
    bsz, s0 = prompt.shape
    max_len = max_len or (s0 + steps)
    if s0 + steps > max_len:
        raise ValueError(
            f"prompt({s0}) + steps({steps}) exceeds max_len={max_len}")
    last, cache = state.prefill(prompt, max_len=max_len)
    toks = []
    for i in range(steps):
        tok = torch.argmax(last, dim=-1)
        toks.append(tok)
        last, cache = state.decode_step(tok[:, None], s0 + i, cache)
    tokens = (torch.stack(toks, dim=1) if toks
              else prompt.new_zeros((bsz, 0)))
    return GenerationResult(tokens=tokens, logits_last=last)
