"""Gradient compression for DP sync: int8 quantized all-to-all reduce.

The port of the JAX package's ``distributed/compression.py``, on a
``torch.distributed`` process group. Ring all-reduce moves ~8
bytes/element (f32, 2 passes). The compressed schedule moves ~2
bytes/element:
  1. per-destination-chunk int8 quantization (per-chunk max-abs scale),
  2. all_to_all so each rank owns one chunk from every peer,
  3. local dequant + sum (``sum(axis=0) / N``, the reference's order),
  4. requantize, all_gather int8, dequant.
Rounding is half to even in both packages (``torch.round``,
``jnp.round``), clipped to +-127, with the scale floored at 1e-20. The
functions run on every rank of `group` (None: the default group), where
the reference's run inside shard_map over the DP axis.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _quant(x, dim=None):
    if dim is None:
        scale = x.abs().max()
    else:
        scale = x.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(scale, min=1e-20)
    q = torch.clamp(torch.round(x / scale * 127.0), -127, 127).to(torch.int8)
    return q, scale


def int8_allreduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Compressed mean-all-reduce of x (any shape) over `group`."""
    n_ranks = dist.get_world_size(group)
    flat = x.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    pad = (-n) % n_ranks
    flat = torch.nn.functional.pad(flat, (0, pad))
    chunks = flat.reshape(n_ranks, -1)                   # row i -> rank i
    q, s = _quant(chunks, dim=1)                         # (N, c) int8, (N, 1)
    q_in, s_in = torch.empty_like(q), torch.empty_like(s)
    dist.all_to_all_single(q_in, q, group=group)         # row j <- rank j
    dist.all_to_all_single(s_in, s, group=group)
    part = torch.sum(q_in.to(torch.float32) * s_in / 127.0, dim=0) / n_ranks
    q2, s2 = _quant(part)
    q2_all = torch.empty(n_ranks * q2.shape[0], dtype=torch.int8, device=x.device)
    s2_all = torch.empty(n_ranks, dtype=torch.float32, device=x.device)
    dist.all_gather_into_tensor(q2_all, q2, group=group)
    dist.all_gather_into_tensor(s2_all, s2.reshape(1), group=group)
    q2_all = q2_all.reshape(n_ranks, -1)                 # (N, c) int8
    full = (q2_all.to(torch.float32) * (s2_all[:, None] / 127.0)).reshape(-1)
    return full[:n].reshape(x.shape).to(x.dtype)


def tree_int8_allreduce_mean(tree: dict[str, torch.Tensor], group=None
                             ) -> dict[str, torch.Tensor]:
    return {k: int8_allreduce_mean(g, group) for k, g in tree.items()}


def tree_psum_mean(tree: dict[str, torch.Tensor], group=None
                   ) -> dict[str, torch.Tensor]:
    """The mean over `group` of each leaf (the reference's pmean): a sum
    all-reduce in place, divided by the ranks."""
    n_ranks = dist.get_world_size(group)
    out = {}
    for k, g in tree.items():
        dist.all_reduce(g, group=group)
        out[k] = g.div_(n_ranks)
    return out
