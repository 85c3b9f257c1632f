"""AdamW with decoupled weight decay (paper recipe: b1=0.95, b2=0.98).

The port of the JAX package's ``optim/adamw.py``, term for term: moments
m and v in float32, bias correction with a float count, and

    step = (m / bc1) / (sqrt(v / bc2) + eps) + weight_decay * mask * p
    p    = p - lr * step

The state is keyed by the LM's parameter names. ``adamw_update`` writes
the new values into the parameters in place (they are the module's own
tensors), and the new m and v into the state's own moment tensors: a
step never holds a second copy of the moments (8 bytes a parameter, 8.4
GB for recurrentgemma-9b's embedding alone). The state passed in is
therefore the state returned, less its count. A large parameter is
updated a slab of leading rows at a time (at most ``SLAB`` elements), so
that the update's temporaries stay small beside a 4 GiB expert tensor;
the arithmetic is elementwise, so the bits are those of one whole pass.

The weight-decay mask is the reference's ``_wd_mask``, taken on the
reference's tree: there the pattern groups are stacked, so every leaf
under ``groups/`` (norm scales, biases and 1-D recurrent parameters
included) has ndim >= 2 and is decayed. A leaf of the unstacked tail
(``tail/``, e.g. recurrentgemma's last two layers) or at the top level
(``final_norm/*``) is decayed by its own ndim, and a frozen random sketch
projection (a path ending in ``/g``) never is. The encoder-decoder
stacks its encoder and decoder layers (``enc/``, ``dec/``): every leaf
under them is decayed, while ``enc_norm`` and ``dec_norm`` (not under
``enc/``) are not; an untied ``lm_head`` is (ndim 2). The layout comes
from the config (``bridge.jax_path``, ``bridge.is_stacked``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.bridge import is_stacked, jax_path


SLAB = 1 << 26     # elements of a parameter updated at once (256 MiB in f32)


class AdamWState(NamedTuple):
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]
    count: torch.Tensor            # int32, 0-d


def decay_mask(params: dict[str, torch.Tensor], cfg) -> dict[str, float]:
    """1.0 for the parameters the reference decays, else 0.0."""
    def decayable(name, p):
        path = jax_path(name, cfg)
        if path.endswith("/g"):    # frozen random sketch projection
            return 0.0
        if is_stacked(path, cfg):  # ndim >= 2 in the reference
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
def adamw_update(grads, state: AdamWState, params, *, lr, cfg, b1=0.95,
                 b2=0.98, eps=1e-8, weight_decay=0.1) -> AdamWState:
    """One AdamW step: the parameters are updated in place; returns the
    new state. lr: a float or a float32 0-d tensor; `cfg` gives the
    decay mask's layout (decay_mask)."""
    count = state.count + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=c.device), c)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=c.device), c)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=c.device)
    mask = decay_mask(params, cfg)
    for name, p in params.items():
        wd = weight_decay * mask[name]
        for rows in _slabs(p):
            g32 = grads[name][rows].to(torch.float32)
            # in place, rounding as b1 * m + (1 - b1) * g32 does
            m = state.m[name][rows].mul_(b1).add_((1 - b1) * g32)
            v = state.v[name][rows].mul_(b2).add_((1 - b2) * g32 * g32)
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            pr = p[rows]
            step = step + wd * pr.to(torch.float32)
            pr.copy_((pr - lr * step.to(p.dtype)).to(p.dtype))
    return AdamWState(m=state.m, v=state.v, count=count)


def _slabs(p):
    """Index slices of p's leading axis, each at most SLAB elements (one
    row at least); a 0-d or small tensor is one slab (`...`)."""
    if p.dim() == 0 or p.numel() <= SLAB:
        return [...]
    per = max(1, SLAB // (p.numel() // p.shape[0]))
    return [slice(s, s + per) for s in range(0, p.shape[0], per)]


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.values()))


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm, norm=None):
    """Scale grads in place so that their global norm is at most max_norm
    (the bits of (g.float() * scale).to(g.dtype)); returns (grads, the
    norm before scaling). `norm`, when given, is that norm (the sharded
    step takes it over every rank's blocks)."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {n: g.mul_(scale) for n, g in grads.items()}, norm
