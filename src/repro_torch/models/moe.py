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

Over a mesh (``distributed/tensor_parallel.py``) the port computes what
the reference's one device computes on the whole call:

- Expert parallelism. Under rules that keep "experts" on "model"
  (training) each "model" rank holds E/M whole experts and E/M router
  columns. The block's input goes through ``tp.enter``; the router logits
  are gathered whole before the softmax (``tp.gather_model``), so every
  rank takes the same top-k, plan and aux losses; each rank fills the
  buffer rows of its own experts and runs their GLU, and the outputs are
  gathered whole into (E, G * cap, D) before the combine, which sums in
  the one-device order.
- The batch axes (``tp.split_rows``: a training step's data-parallel
  ranks). The reference's G dispatch groups
  are aligned to the data shards: when the D ranks divide G each rank
  dispatches its G / D groups of its own rows (capacity reckoned on the
  same T / G tokens) and the aux losses' means are sums over the rows
  all-reduced over the batch axes (``tp.rows_sum``); otherwise the call's
  rows are gathered (``tp.rows_gather``), routed, dispatched and combined
  as on one device, and each rank keeps its rows of the output.

The serving engine's decode tick routes each slot's token as a call of
its own (``each_row_alone``), as the reference's tick,
which maps its decode step over the slots with ``jax.vmap``: one token's
k assignments go to k experts with room for it (``capacity(cfg, 1)`` is
at least 8), so nothing drops, and the tick's batch is one group whose
capacity is its token count.
"""
from __future__ import annotations

import contextlib
import hashlib
import math
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import shard_act
from repro_torch.models.layers import dense_init
from repro_torch.utils import normal_param

CAST_BYTES = 2 << 30     # the most one expert weight's cast may hold at once

_ALONE = threading.local()


@contextlib.contextmanager
def each_row_alone():
    """Inside, on this thread: every row of an MoE call (one token a row:
    a decode tick's slot) is routed as a call of its own, as the
    reference's vmapped tick routes it."""
    before = rows_alone()
    _ALONE.on = True
    try:
        yield
    finally:
        _ALONE.on = before


def rows_alone() -> bool:
    return getattr(_ALONE, "on", False)


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


def route(moe: MoE, cfg, xf, experts: tuple[int, int] | None = None):
    """xf: (T, D) -> (logits (T, E) f32, probs, gate (T, k) renormalised,
    ids (T, k)). `experts` [lo, hi): this rank's experts (default all);
    when they are not all, the router holds their columns and its block of
    the logits is gathered whole over "model"."""
    logits = (xf @ moe.router.to(xf.dtype)).float()
    if experts is not None and experts != (0, cfg.n_experts):
        logits = tp.gather_model(logits, -1)
    probs = torch.softmax(logits, dim=-1)
    gate, ids = top_k(probs, cfg.moe_top_k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gate, ids


def aux_losses(cfg, logits, probs, ids, split=None) -> dict[str, torch.Tensor]:
    """The load balance and the router z-loss over the call's rows; with
    `split` (tp.Rows) the call is this rank's share of rows split over the
    batch axes, and the means are over all of them: each rank's sums
    all-reduced (tp.rows_sum)."""
    e = cfg.n_experts
    if split is None:
        density = F.one_hot(ids[:, 0], e).float().mean(0)
        return {"load_balance": e * torch.sum(density * probs.mean(0)),
                "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)}
    sums = tp.rows_sum(torch.cat([
        F.one_hot(ids[:, 0], e).float().sum(0), probs.sum(0),
        torch.sum(torch.logsumexp(logits, dim=-1) ** 2)[None]]))
    mean = sums / (ids.shape[0] * split.size)
    return {"load_balance": e * torch.sum(mean[:e] * mean[e:2 * e]),
            "router_z": mean[-1]}


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


def dispatch_plan(cfg, ids, groups: int | None = None, cap: int | None = None) -> Plan:
    """The plan of (T, k) assignments in `groups` groups (default the
    config's moe_dispatch_groups), each expert holding `cap` slots a group
    (default the reference's capacity)."""
    e, k = cfg.n_experts, cfg.moe_top_k
    g = max(1, cfg.moe_dispatch_groups if groups is None else groups)
    t = ids.shape[0]
    if t % g:
        raise ValueError(f"{t} tokens do not split into {g} dispatch groups")
    tg = t // g
    cap = capacity(cfg, tg) if cap is None else cap
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


def plan_digest(plan: Plan) -> str:
    """A hash of a plan's routing decisions (which assignment goes to
    which buffer row, and which are dropped): equal on ranks that routed
    alike."""
    h = hashlib.sha256(str(plan.cap).encode())
    for x in (plan.order, plan.slot, plan.keep):
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def dispatch(cfg, plan: Plan, xg, experts: tuple[int, int] | None = None):
    """The (E, G * cap, D) expert buffer from xg (G, tg, D): slot (expert,
    p) of a group holds the assignment at sorted position seg_start[expert]
    + p while p < count[expert], zeros past it. `experts` [lo, hi): only
    those experts' rows, (hi - lo, G * cap, D)."""
    k = cfg.moe_top_k
    lo, hi = (0, cfg.n_experts) if experts is None else experts
    e = hi - lo
    g, tg, d = xg.shape
    cap = plan.cap
    p = torch.arange(cap, device=xg.device)
    src = (plan.seg_start[:, lo:hi, None] + p).clamp(max=tg * k - 1).reshape(g, e * cap)
    filled = (p < plan.count[:, lo:hi, None]).reshape(g, e * cap, 1)
    tok = plan.order.gather(-1, src) // k
    buf = torch.where(filled, xg.gather(1, tok[..., None].expand(g, e * cap, d)),
                      xg.new_zeros(()))
    return buf.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)


def cast_experts(moe: MoE, s: int, n: int, dt):
    """(wg, wi, wo) of experts s .. s + n - 1 in dtype dt."""
    whole = s == 0 and n == moe.wg.shape[0]
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
    """x: (B, S, D) -> (y (B, S, D), aux losses: {} without with_aux). Over
    a mesh, what one device computes on the whole call (module docstring)."""
    bsz, s, d = x.shape
    t = bsz * s
    e = cfg.n_experts
    experts = tp.expert_range(e)
    if experts != (0, e):
        if moe.wg.shape[0] != experts[1] - experts[0]:
            raise ValueError(f"the rules split {e} experts over 'model', but this "
                             f"rank's weights hold {moe.wg.shape[0]}")
        x = tp.enter(x)
    xf = shard_act(x.reshape(t, d), "batch")
    split, groups, cap = tp.rows(), max(1, cfg.moe_dispatch_groups), None
    gathered = split is not None and groups % split.size != 0
    if gathered:            # the data shards do not divide the groups
        xf = tp.rows_gather(xf)
    elif split is not None:
        groups //= split.size
    if rows_alone():
        if s != 1:
            raise ValueError(f"rows routed alone hold one token each, not {s}")
        # a token alone never drops: one group with room for every token
        groups, cap = 1, t
    logits, probs, gate, ids = route(moe, cfg, xf, experts)
    aux = {}
    if with_aux:
        aux = aux_losses(cfg, logits, probs, ids, None if gathered else split)
    plan = dispatch_plan(cfg, ids, groups, cap)
    buf = shard_act(dispatch(cfg, plan, xf.reshape(groups, -1, d), experts),
                    "experts", "batch")
    hout = expert_glu(moe, buf)
    if experts != (0, e):
        hout = tp.gather_model(hout, 0)
    hout = shard_act(hout, "experts", "batch")
    y = combine(cfg, plan, hout, gate, ids)
    if gathered:
        y = y.narrow(0, split.index * t, t)
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

