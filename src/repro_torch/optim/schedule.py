"""LR schedules. Paper: linear warmup for the first 10% of steps, then
linear decay (Appendix G).

The port of the JAX package's ``optim/schedule.py``: each schedule maps a
step to the learning rate as a float32 0-d tensor, computed in float32 in
the reference's order, so both packages give the same bits. The lr at
step 0 is 0.
"""
from __future__ import annotations

import math

import torch


def linear_warmup_linear_decay(peak_lr: float, total_steps: int,
                               warmup_frac: float = 0.1):
    warm = max(1, int(total_steps * warmup_frac))

    def schedule(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        up = peak_lr * step / warm
        down = (peak_lr * torch.clamp(total_steps - step, min=0.0)
                / max(1, total_steps - warm))
        return torch.where(step < warm, up, down)

    return schedule


def cosine_decay(peak_lr: float, total_steps: int, warmup_frac: float = 0.1,
                 floor: float = 0.1):
    warm = max(1, int(total_steps * warmup_frac))

    def schedule(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        up = peak_lr * step / warm
        t = torch.clamp((step - warm) / max(1, total_steps - warm), 0.0, 1.0)
        down = peak_lr * (floor + (1 - floor) * 0.5
                          * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warm, up, down)

    return schedule
