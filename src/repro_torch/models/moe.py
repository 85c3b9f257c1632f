"""Mixture-of-Experts FFN with sort-based token-choice dispatch.

Port of the JAX package's ``models/moe.py`` (``moe_init``, ``moe_apply``,
``moe_apply_dense_oracle``), term for term:

- Token-choice top-k routing: a softmax router in float32 over a product
  in the compute dtype, the top k (ties to the lower expert index, as
  ``jax.lax.top_k``), gates renormalised to sum to one.
- Aux losses: switch-style load balance ``e * sum(density * mean prob)``
  with the density of each token's first choice only, and the router
  z-loss, the mean of logsumexp(logits)^2.
- Dispatch within ``moe_dispatch_groups`` groups of tg = T / G tokens,
  each expert holding ``cap = ceil(tg * k / e * capacity_factor / mult) *
  mult`` slots (mult 256 once tg * k / e reaches 256, else 8). The
  (T * k) assignments of a group are argsorted stably by expert; an
  assignment's position within its expert comes from the segment
  offsets, and one past the expert's capacity is dropped (its output
  counts zero, the other gates are not renormalised). Capacity couples
  the tokens of one call: a decode tick, a prefill chunk and a train-mode
  forward of the same text route alike only while nothing drops.
- The expert GLU ``gelu(x wg) * (x wi) @ wo`` (tanh GELU) on the (E, G *
  cap, D) buffer, and the weighted combine.

Two departures in form, none in value. The buffer is filled by a
gather (slot p of expert e takes the assignment at sorted position
seg_start[e] + p while p < count[e]) where the reference scatters into
it: every slot is written once either way. The combine gathers each
token's k expert rows and sums them in ascending expert order, the
order in which the reference's scatter-add meets them, instead of a
scatter-add, whose CUDA atomics would sum in a different order on every
run. The f32 expert weights are cast to the compute dtype a group of
experts at a time (at most ``CAST_BYTES`` a weight), so that a 10 GiB
whole-tensor cast of llama4-maverick's experts never sits beside its
60 GiB of f32 weights. The expert products are plain batched matrix
products, as the reference's are (no Pallas kernel).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import shard_act
from repro_torch.models.layers import dense_init
from repro_torch.utils import normal_param

CAST_BYTES = 2 << 30     # the most one expert weight's cast may hold at once


class MoE(nn.Module):
    """router (D, E); wi, wg (E, D, F); wo (E, F, D): the reference's
    layouts and init scales (fan-in normal)."""

    def __init__(self, cfg, *, generator=None, device="cpu"):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        kw = dict(generator=generator, device=device)
        self.cfg = cfg
        self.router = dense_init(d, (e,), **kw)
        self.wi = normal_param((e, d, f), 1.0 / math.sqrt(d), **kw)
        self.wg = normal_param((e, d, f), 1.0 / math.sqrt(d), **kw)
        self.wo = normal_param((e, f, d), 1.0 / math.sqrt(f), **kw)

    def forward(self, x, with_aux: bool = True):
        return moe_apply(self, self.cfg, x, with_aux=with_aux)


def top_k(x, k: int):
    """jax.lax.top_k over the last axis: the k largest values and their
    indices, the lower index first among equal values (a stable sort;
    torch.topk promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(moe: MoE, cfg, xf):
    """xf: (T, D) -> (logits (T, E) f32, probs, gate (T, k) renormalised,
    ids (T, k))."""
    logits = (xf @ moe.router.to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate, ids = top_k(probs, cfg.moe_top_k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gate, ids


def aux_losses(cfg, logits, probs, ids) -> dict[str, torch.Tensor]:
    e = cfg.n_experts
    density = F.one_hot(ids[:, 0], e).float().mean(0)
    return {"load_balance": e * torch.sum(density * probs.mean(0)),
            "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)}


def capacity(cfg, tg: int) -> int:
    """Slots an expert holds in a group of tg tokens (the reference's rule)."""
    e, k = cfg.n_experts, cfg.moe_top_k
    mult = 256 if tg * k // e >= 256 else 8
    return int(math.ceil(tg * k / e * cfg.capacity_factor / mult)) * mult


class Plan(NamedTuple):
    """A group-wise dispatch of (T, k) assignments, each row one group, in
    sorted (expert-major, stable) order: `order` the flat assignment
    (token * k + choice) at each position, `slot` its buffer row (e * cap
    + position in its expert, or the sentinel e * cap when dropped),
    `keep`, and per expert its first position `seg_start` and `count`."""
    cap: int
    order: torch.Tensor        # (G, tg * k)
    slot: torch.Tensor         # (G, tg * k)
    keep: torch.Tensor         # (G, tg * k) bool
    seg_start: torch.Tensor    # (G, E)
    count: torch.Tensor        # (G, E)


def dispatch_plan(cfg, ids) -> Plan:
    e, k = cfg.n_experts, cfg.moe_top_k
    g = max(1, cfg.moe_dispatch_groups)
    t = ids.shape[0]
    if t % g:
        raise ValueError(f"{t} tokens do not split into {g} dispatch groups")
    tg = t // g
    cap = capacity(cfg, tg)
    flat = ids.reshape(g, tg * k)
    order = torch.argsort(flat, dim=-1, stable=True)
    sorted_ids = flat.gather(-1, order)
    experts = torch.arange(e, device=ids.device).expand(g, e).contiguous()
    seg_start = torch.searchsorted(sorted_ids, experts)
    count = torch.searchsorted(sorted_ids, experts, right=True) - seg_start
    pos = torch.arange(tg * k, device=ids.device) - seg_start.gather(-1, sorted_ids)
    keep = pos < cap
    slot = torch.where(keep, sorted_ids * cap + pos, e * cap)
    return Plan(cap, order, slot, keep, seg_start, count)


def dispatch(cfg, plan: Plan, xg):
    """The (E, G * cap, D) expert buffer from xg (G, tg, D): slot (expert,
    p) of a group holds the assignment at sorted position seg_start[expert]
    + p while p < count[expert], zeros past it."""
    e, k = cfg.n_experts, cfg.moe_top_k
    g, tg, d = xg.shape
    cap = plan.cap
    p = torch.arange(cap, device=xg.device)
    src = (plan.seg_start[..., None] + p).clamp(max=tg * k - 1).reshape(g, e * cap)
    filled = (p < plan.count[..., None]).reshape(g, e * cap, 1)
    tok = plan.order.gather(-1, src) // k
    buf = torch.where(filled, xg.gather(1, tok[..., None].expand(g, e * cap, d)),
                      xg.new_zeros(()))
    return buf.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)


def cast_experts(moe: MoE, s: int, n: int, dt):
    """(wg, wi, wo) of experts s .. s + n - 1 in dtype dt."""
    whole = s == 0 and n == moe.cfg.n_experts
    return tuple((w if whole else w[s:s + n]).to(dt) for w in (moe.wg, moe.wi, moe.wo))


def expert_glu(moe: MoE, x):
    """The expert GLU on x (E, N, D) in x's dtype, the weights cast a group
    of experts at a time (at most CAST_BYTES a weight)."""
    dt = x.dtype
    e, _, d = x.shape
    per = d * moe.cfg.d_ff * dt.itemsize
    n = e if moe.wg.dtype == dt else max(1, min(e, CAST_BYTES // per))
    groups = -(-e // n)
    n = -(-e // groups)                  # groups of even size
    outs = []
    for s in range(0, e, n):
        wg, wi, wo = cast_experts(moe, s, n, dt)
        xs = x if n == e else x[s:s + n]
        h = F.gelu(torch.bmm(xs, wg), approximate="tanh") * torch.bmm(xs, wi)
        outs.append(torch.bmm(h, wo))
        del wg, wi, wo
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def combine(cfg, plan: Plan, hout, gate, ids):
    """y (T, D): each token's k expert rows of hout (E, G * cap, D), zero
    where dropped, times its gates, summed in ascending expert order (the
    order of the reference's scatter-add; no atomics)."""
    e, k = cfg.n_experts, cfg.moe_top_k
    g, cap = plan.order.shape[0], plan.cap
    t, d = ids.shape[0], hout.shape[-1]
    hout = hout.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
    inv = torch.argsort(plan.order, dim=-1)            # flat assignment -> position
    slot = plan.slot.gather(-1, inv).reshape(t, k)
    keep = plan.keep.gather(-1, inv).reshape(t, k)
    by_expert = torch.argsort(ids, dim=-1)
    slot, keep = slot.gather(1, by_expert), keep.gather(1, by_expert)
    w = gate.gather(1, by_expert).to(hout.dtype)
    rows = slot.clamp(max=e * cap - 1).reshape(g, t // g * k)
    got = hout.gather(1, rows[..., None].expand(*rows.shape, d)).reshape(t, k, d)
    c = torch.where(keep[..., None], got, got.new_zeros(())) * w[..., None]
    y = c[:, 0]
    for j in range(1, k):
        y = y + c[:, j]
    return y


def moe_apply(moe: MoE, cfg, x, *, with_aux: bool = True):
    """x: (B, S, D) -> (y (B, S, D), aux losses: {} without with_aux)."""
    bsz, s, d = x.shape
    t = bsz * s
    xf = shard_act(x.reshape(t, d), "batch")
    logits, probs, gate, ids = route(moe, cfg, xf)
    aux = aux_losses(cfg, logits, probs, ids) if with_aux else {}
    plan = dispatch_plan(cfg, ids)
    buf = shard_act(dispatch(cfg, plan, xf.reshape(plan.order.shape[0], -1, d)),
                    "experts", "batch")
    y = combine(cfg, plan, expert_glu(moe, buf), gate, ids)
    return y.reshape(bsz, s, d), aux


def moe_apply_dense_oracle(moe: MoE, cfg, x):
    """O(T * E) oracle: every expert runs every token (tests only)."""
    bsz, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    xf = x.reshape(-1, d)
    dt = x.dtype
    _, _, gate, ids = route(moe, cfg, xf)
    hgate = F.gelu(torch.einsum("td,edf->etf", xf, moe.wg.to(dt)), approximate="tanh")
    hin = torch.einsum("td,edf->etf", xf, moe.wi.to(dt))
    hout = shard_act(torch.einsum("etf,efd->etd", hgate * hin, moe.wo.to(dt)),
                     "experts", "batch")
    mask = torch.zeros(xf.shape[0], e, dtype=torch.float32, device=x.device)
    for j in range(k):
        mask = mask + F.one_hot(ids[:, j], e).float() * gate[:, j:j + 1]
    y = torch.einsum("etd,te->td", hout, mask.to(dt))
    return y.reshape(bsz, s, d)

