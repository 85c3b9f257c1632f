"""AdamW with decoupled weight decay (paper recipe: b1=0.95, b2=0.98).

The port of the JAX package's ``optim/adamw.py``, term for term: moments
m and v in float32, bias correction with a float count, and

    step = (m / bc1) / (sqrt(v / bc2) + eps) + weight_decay * mask * p
    p    = p - lr * step

The state is keyed by the LM's parameter names. ``adamw_update`` writes
the new values into the parameters in place (they are the module's own
tensors); m and v come back as new tensors.

The weight-decay mask is the reference's ``_wd_mask``, taken on the
reference's tree: there the layers are stacked, so every per-layer leaf
(norm scales and biases included) has ndim >= 2 and is decayed. Only a
top-level leaf of ndim < 2 (``final_norm/*``) and a frozen random sketch
projection (a path ending in ``/g``) escape decay.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.bridge import LAYER_GROUP, jax_path


class AdamWState(NamedTuple):
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]
    count: torch.Tensor            # int32, 0-d


def decay_mask(params: dict[str, torch.Tensor]) -> dict[str, float]:
    """1.0 for the parameters the reference decays, else 0.0."""
    def decayable(name, p):
        path = jax_path(name)
        if path.endswith("/g"):    # frozen random sketch projection
            return 0.0
        if path.startswith(LAYER_GROUP):   # stacked in the reference
            return 1.0
        return 1.0 if p.dim() >= 2 else 0.0

    return {name: decayable(name, p) for name, p in params.items()}


def adamw_init(params: dict[str, torch.Tensor]) -> AdamWState:
    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}
    dev = next(iter(params.values())).device
    return AdamWState(m=zeros(), v=zeros(),
                      count=torch.zeros((), dtype=torch.int32, device=dev))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr, b1=0.95, b2=0.98,
                 eps=1e-8, weight_decay=0.1) -> AdamWState:
    """One AdamW step: the parameters are updated in place; returns the
    new state. lr: a float or a float32 0-d tensor."""
    count = state.count + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=c.device), c)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=c.device), c)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=c.device)
    mask = decay_mask(params)
    new_m, new_v = {}, {}
    for name, p in params.items():
        g32 = grads[name].to(torch.float32)
        m = b1 * state.m[name] + (1 - b1) * g32
        v = b2 * state.v[name] + (1 - b2) * g32 * g32
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        step = step + weight_decay * mask[name] * p.to(torch.float32)
        p.copy_((p - lr * step.to(p.dtype)).to(p.dtype))
        new_m[name], new_v[name] = m, v
    return AdamWState(m=new_m, v=new_v, count=count)


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.values()))


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm):
    """(grads scaled so that their global norm is at most max_norm, the
    norm before scaling)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {n: (g.to(torch.float32) * scale).to(g.dtype)
            for n, g in grads.items()}, norm
