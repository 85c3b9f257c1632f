"""Deterministic, checkpointable data iterator.

The port of the JAX package's ``data/loader.py`` ``DataIterator``:
batches are a pure function of (seed, step), so the iterator's state is
two ints and a run restarts from any step. Batches come as tensors on an
explicit device: tokens as int64 (B, S+1), the optional loss mask as
float32 (B, S).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


class DataIterator:
    """Wraps sample(batch, seq, step) -> tokens or (tokens, mask)."""

    def __init__(self, sample_fn: Callable, batch: int, seq: int, *,
                 seed: int = 0, start_step: int = 0, device="cpu"):
        self._fn = sample_fn
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.step = start_step
        self.device = torch.device(device)

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, torch.Tensor]:
        out = self._fn(self.batch, self.seq, self.step)
        self.step += 1
        if isinstance(out, tuple):
            tokens, mask = out
        else:
            tokens, mask = out, None
        batch = {"tokens": torch.from_numpy(np.asarray(tokens, np.int64))}
        if mask is not None:
            batch["loss_mask"] = torch.from_numpy(np.asarray(mask, np.float32))
        return {k: v.to(self.device) for k, v in batch.items()}

    # --- checkpointable state ---
    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def restore(self, state: dict) -> None:
        if int(state["seed"]) != self.seed:
            raise ValueError(f"data seed mismatch on restore: checkpoint "
                             f"{state['seed']}, iterator {self.seed}")
        self.step = int(state["step"])
