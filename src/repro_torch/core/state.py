"""DecodeState protocol: a family-agnostic cache / prefill / snapshot API.

Port of the JAX package's ``core/state.py`` for every decode-state kind:
``polysketch``, ``poly_kv``, ``kv_full`` and ``kv_ring`` here, ``ssd``
and ``rglru`` registered by ``models/ssm.py`` and ``models/rglru.py`` on
import. The serve
engine, ``generate`` and the scheduler speak only this protocol and never
branch on the family or the mechanism:

- ``StateSpec`` (registry, keyed by state *kind*): how to build one
  layer's cache node and what the kind supports (snapshot granularity,
  resumable prefill).
- Node-level snapshot ops, keyed by cache-node *type*
  (``PolysketchCache``, ``KVCache``, ``RecurrentCache``,
  ``RingKVCache``): ``snapshot_state`` and ``restore_state`` walk a model
  cache (a list of per-layer nodes) and dispatch per node, so a hybrid
  model's cache snapshots with no model-specific code.
- ``DecodeState``: the model-level facade (built by ``model_zoo``):
  ``init / init_slot / prefill / resume / decode_step / snapshot /
  restore / serialize / deserialize``, the partial-prefill carry and the
  slot helpers.

Snapshots and restores copy: a snapshot never shares storage with the
cache it was taken from, nor a restored cache with its snapshot, so a
stored snapshot keeps its bits while live caches are written in place.

Snapshot granularity (per kind, composed over a model's kinds, the
weakest member winning): ``"block"``, valid at the last lt_block_size
boundary, where the partial tail lives in buffers the snapshot omits
(polysketch); ``"token"``, the state covers exactly the tokens so far
(ssd, rglru, and kv_ring, whose O(W) window is a constant-size suffix
state), so a snapshot at a block boundary inside a prompt needs the
prefill split there (serve/scheduler.py does); ``None``, no
constant-size snapshot (full KV).

Prefill of a resumable kind runs on the block grid: a prompt segment goes
through the model in chunks that end on multiples of ``lt_block_size``
(absolute positions), and inside a chunk the SSD and RG-LRU scans and the
ring's sub-blocks run on a fixed grid too. A prefill resumed at a block
boundary therefore makes exactly the calls, on exactly the shapes, that
the cold prefill of the whole prompt makes from there on, and gives the
same bits. A one-shot call over the whole prompt would not: cuBLAS picks
its kernel by shape, and a product over 2040 rows need not round like one
over 1024 + 1016 rows (seen on an H100). The KV kinds are not resumable:
prefill is one call over the whole prompt, written into the cache at
position 0; their cache is sized at init, so ``prefill`` needs
``max_len`` or a pre-built state. A ring's window is min(sliding_window,
max_len), the sliding window when max_len is None.

Positions: a prefill keeps the host int ``pos`` of ``core.decode``;
``decode_step`` takes an int shared by the batch or a (B,) tensor, one per
row (the engine's slots).
"""
from __future__ import annotations

import io
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import effective_pattern
from repro_torch.core import decode as dec


# ---------------------------------------------------------------------------
# node-level snapshot ops (dispatch by cache-node type)
# ---------------------------------------------------------------------------

class NodeOps(NamedTuple):
    granularity: str | None          # "block" | "token" | None
    snapshot: Callable | None        # node -> constant-size snapshot
    restore: Callable | None         # (fresh_node, snapshot, n_tokens) -> node


def _psk_snapshot(node: dec.PolysketchCache):
    # valid at block-aligned positions, where the buffers are empty by
    # construction: the folded prefix state is the whole story. A copy: a
    # stored snapshot never shares storage with a live cache, which the
    # engine updates in place
    return node.z.clone()


def _psk_restore(fresh: dec.PolysketchCache, z, n_tokens):
    # a copy for the same reason: the restored cache goes on to be written
    # while the snapshot stays in the prefix cache
    return fresh._replace(z=z.to(device=fresh.z.device, dtype=fresh.z.dtype,
                                 copy=True),
                          pos=int(n_tokens))


def _copy_to(x, like):
    return x.to(device=like.device, dtype=like.dtype, copy=True)


def _rec_snapshot(node: dec.RecurrentCache):
    # the whole node is constant-size; h covers exactly the tokens so far
    return dec.RecurrentCache(h=node.h.clone(), conv=node.conv.clone())


def _rec_restore(fresh: dec.RecurrentCache, snap: dec.RecurrentCache,
                 n_tokens):
    del n_tokens  # the position lives with the caller, not the node
    return dec.RecurrentCache(h=_copy_to(snap.h, fresh.h),
                              conv=_copy_to(snap.conv, fresh.conv))


def _ring_snapshot(node: dec.RingKVCache):
    # the whole node is O(W): the ring holds exactly the last min(pos, W)
    # tokens, the entire state a sliding-window resume needs
    return dec.RingKVCache(k=node.k.clone(), v=node.v.clone(),
                           pos=int(node.pos))


def _ring_restore(fresh: dec.RingKVCache, snap: dec.RingKVCache, n_tokens):
    return dec.RingKVCache(k=_copy_to(snap.k, fresh.k),
                           v=_copy_to(snap.v, fresh.v), pos=int(n_tokens))


NODE_OPS: dict[type, NodeOps] = {
    dec.PolysketchCache: NodeOps("block", _psk_snapshot, _psk_restore),
    dec.RecurrentCache: NodeOps("token", _rec_snapshot, _rec_restore),
    dec.RingKVCache: NodeOps("token", _ring_snapshot, _ring_restore),
    dec.KVCache: NodeOps(None, None, None),
}


def snapshot_fields(snap) -> list:
    """One layer's snapshot as its leaves, in the reference's tree order: a
    tensor (polysketch's z), or the node's fields (tensors, and a ring's
    int position)."""
    return [snap] if torch.is_tensor(snap) else list(snap)


def snapshot_tensors(snapshot) -> list[torch.Tensor]:
    """Every tensor of a model snapshot (a list of per-layer snapshots)."""
    return [x for snap in snapshot for x in snapshot_fields(snap)
            if torch.is_tensor(x)]


def snapshot_state(state):
    """Constant-size snapshot of a model cache (per-node dispatch): a list
    with one snapshot per layer. Raises for node types with none (KV)."""
    def snap(node):
        ops = NODE_OPS[type(node)]
        if ops.snapshot is None:
            raise ValueError(
                f"{type(node).__name__} decode state does not support "
                "constant-size snapshots")
        return ops.snapshot(node)
    return [snap(node) for node in state]


def restore_state(fresh_state, snapshot, n_tokens):
    """Rebuild a model cache from a snapshot; `fresh_state` supplies the
    structure and zeros, `n_tokens` the restored position (block-aligned
    for block-granularity nodes)."""
    return [NODE_OPS[type(node)].restore(node, snap, n_tokens)
            for node, snap in zip(fresh_state, snapshot)]


# ---------------------------------------------------------------------------
# shard axes: the logical names of each cache leaf's dims
# ---------------------------------------------------------------------------
#
# As the reference's: only the batch (slot) dim and, for attention states,
# the kv-head dim are named; every reduction runs within one head and one
# row, so a plan that splits them keeps each row's bits. An int position
# is a scalar (no names); the slot stack's (slots,) positions are "batch".

def _rank(x) -> int:
    return x.dim() if torch.is_tensor(x) else 0


def heads_shard_axes(node):
    """("batch", "kv_heads", ...) for the (B, Hkv, ...) leaves of an
    attention-state node; batch-only for lower-rank leaves; () for a
    scalar position."""
    def one(x):
        nd = _rank(x)
        if nd == 0:
            return ()
        if nd >= 4:
            return ("batch", "kv_heads") + (None,) * (nd - 2)
        return ("batch",) + (None,) * (nd - 1)
    return type(node)(*(one(x) for x in node))


def batch_shard_axes(node):
    """Leading-batch-only axes: the conservative declaration for recurrent
    states whose channel mixing (the conv over d_inner + 2n channels)
    crosses what a per-head split would cut."""
    def one(x):
        nd = _rank(x)
        return ("batch",) + (None,) * (nd - 1) if nd else ()
    return type(node)(*(one(x) for x in node))


# node type -> (node -> same-structure node of logical-name tuples);
# filled by register_state from each StateSpec's shard_axes
NODE_SHARD_AXES: dict[type, Callable] = {}


def state_shard_axes(state) -> list:
    """The logical axes of a model cache (a list of per-layer nodes): a
    node of name tuples per layer, through each kind's declaration.

    The engine's slot stack keeps its slots on the batch axis
    (core.decode.broadcast_slot_caches), so the same call names a
    slot-stacked cache: its slot dim is "batch", and its per-slot
    positions are ("batch",). The reference's slot stack has a leading
    slot axis over batch-1 caches, and its ``slot_stacked=True`` names it
    "batch" in front of the inner batch-1 dim's; the port has no inner
    dim, so its names are the reference's without that one."""
    return [NODE_SHARD_AXES.get(type(node), batch_shard_axes)(node)
            for node in state]


def snapshot_map_heads(snapshot, fn):
    """`snapshot` (a list of per-layer snapshots) with fn applied to every
    tensor that an attention state splits over its kv heads (dim 1: a
    polysketch's z, a ring's k and v); a recurrent layer's snapshot, which
    no head split cuts, as it is. What moves a snapshot between a rank's
    heads and all of them (serve.plan)."""
    def one(snap):
        if torch.is_tensor(snap):                       # polysketch: z
            return fn(snap)
        if isinstance(snap, dec.RingKVCache):
            return snap._replace(k=fn(snap.k), v=fn(snap.v))
        return snap
    return [one(s) for s in snapshot]


# ---------------------------------------------------------------------------
# the kind registry
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StateSpec:
    """One decode-state kind: how to build it and what it supports."""
    kind: str
    node_type: type
    granularity: str | None     # see module docstring
    resumable: bool             # prefill can continue from a prior state
    init: Callable              # (cfg, batch, max_len, dtype, device) -> node
    # (node) -> same-structure node of logical-axis-name tuples naming the
    # partitionable dims (see state_shard_axes); None = batch-only
    shard_axes: Callable | None = None


REGISTRY: dict[str, StateSpec] = {}


def register_state(spec: StateSpec) -> StateSpec:
    REGISTRY[spec.kind] = spec
    if spec.shard_axes is not None:
        NODE_SHARD_AXES[spec.node_type] = spec.shard_axes
    return spec


def get_spec(kind: str) -> StateSpec:
    if kind not in REGISTRY:
        raise KeyError(f"unknown decode-state kind {kind!r}; "
                       f"registered: {sorted(REGISTRY)}")
    return REGISTRY[kind]


def _init_kv(cfg, batch, max_len, dtype, device):
    if max_len is None:
        raise ValueError("a KV cache is sized at init: prefill needs max_len "
                         "(or a pre-built state)")
    return dec.init_kv_cache(batch, cfg.n_kv_heads, cfg.resolved_head_dim,
                             max_len, dtype, device)


register_state(StateSpec(
    kind="polysketch", node_type=dec.PolysketchCache,
    granularity="block", resumable=True,
    init=lambda cfg, batch, max_len, dtype, device: dec.init_polysketch_cache(
        batch, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.sketch_size,
        cfg.lt_block_size, dtype, device),
    shard_axes=heads_shard_axes))

register_state(StateSpec(
    kind="kv_full", node_type=dec.KVCache, granularity=None, resumable=False,
    init=_init_kv, shard_axes=heads_shard_axes))

register_state(StateSpec(
    kind="poly_kv", node_type=dec.KVCache, granularity=None, resumable=False,
    init=_init_kv, shard_axes=heads_shard_axes))


def _init_ring(cfg, batch, max_len, dtype, device):
    window = (cfg.sliding_window if max_len is None
              else min(cfg.sliding_window, max_len))
    return dec.init_ring_cache(batch, cfg.n_kv_heads, cfg.resolved_head_dim,
                               window, dtype, device)


register_state(StateSpec(
    kind="kv_ring", node_type=dec.RingKVCache, granularity="token",
    resumable=True, init=_init_ring, shard_axes=heads_shard_axes))


def mixer_state_kind(cfg, mixer: str = "attn") -> str:
    """The decode-state kind a mixer contributes under this config."""
    if mixer == "attn":
        kinds = {"polysketch": "polysketch", "polynomial": "poly_kv",
                 "softmax": "kv_full"}
        if cfg.attention not in kinds:
            raise ValueError(f"no decode state ported for attention "
                             f"{cfg.attention!r}")
        return kinds[cfg.attention]
    if mixer == "local_attn":
        return "kv_ring"
    if mixer in ("rglru", "ssd"):
        return mixer
    raise ValueError(f"unknown mixer kind {mixer!r}")


def state_kinds(cfg) -> tuple[str, ...]:
    """Distinct decode-state kinds of a config's block pattern (ordered)."""
    return tuple(dict.fromkeys(
        mixer_state_kind(cfg, m) for m in cfg.block_pattern))


def composite_granularity(kinds) -> str | None:
    """Weakest-member snapshot granularity over a model's state kinds."""
    gs = [get_spec(k).granularity for k in kinds]
    if not gs or any(g is None for g in gs):
        return None
    return "block" if all(g == "block" for g in gs) else "token"


# ---------------------------------------------------------------------------
# snapshot (de)serialization
# ---------------------------------------------------------------------------

def snapshot_layout(cfg) -> list[tuple[str, list[int], bool]]:
    """The reference's tree of a model cache, in its leaf order: (node path,
    the port's layer indices it holds, stacked over groups or not). The
    JAX LM stacks each block of its pattern over the groups
    (``groups/block{b}``) and keeps the n_layers % g tail unstacked
    (``tail/block{b}``); dict keys flatten in sorted order. g is the
    effective pattern's length (llama4-maverick's 2: a GLU and an MoE
    layer)."""
    g = len(effective_pattern(cfg))
    n_groups, rem = divmod(cfg.n_layers, g)
    out = []
    for b in sorted(range(g), key=lambda b: f"block{b}") if n_groups else ():
        out.append((f"groups/block{b}", [j * g + b for j in range(n_groups)],
                    True))
    for b in sorted(range(rem), key=lambda b: f"block{b}"):
        out.append((f"tail/block{b}", [n_groups * g + b], False))
    return out


def _host(vals, stacked: bool):
    """One leaf as numpy, stacked over groups (one copy to the host) or a
    single layer's: a bf16 tensor as its int16 bits (numpy has no
    bfloat16), ring positions as int32."""
    if not torch.is_tensor(vals[0]):
        return np.array(vals if stacked else vals[0], dtype=np.int32)
    x = (torch.stack(vals) if stacked else vals[0]).detach()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.cpu().numpy()


def serialize_snapshot(snapshot, n_tokens: int, layout) -> bytes:
    """npz of the snapshot and its position, in the reference's layout:
    ``n_tokens`` and ``leaf{i}`` in JAX's tree-leaf order, each group-
    stacked leaf on a leading group axis (``snapshot_layout``). polysketch's
    z of a dense model is thus one leaf (n_layers, 1, hkv, r^2, h+1). A
    snapshot written by either package loads in the other."""
    leaves = []
    for _, layers, stacked in layout:
        per_layer = [snapshot_fields(snapshot[i]) for i in layers]
        for f in range(len(per_layer[0])):
            leaves.append(_host([fields[f] for fields in per_layer], stacked))
    buf = io.BytesIO()
    np.savez(buf, n_tokens=np.int64(n_tokens),
             **{f"leaf{i}": x for i, x in enumerate(leaves)})
    return buf.getvalue()


def _misfit(what):
    return ValueError(f"snapshot leaves do not fit this model's: {what}")


def _from_host(arr, like, device, stacked: int = 0) -> list:
    """One leaf of serialize's npz back as `like` per layer (one copy to the
    device): `stacked` layers on its leading axis, or one unstacked."""
    want = ((stacked,) if stacked else ()) + (
        tuple(like.shape) if torch.is_tensor(like) else ())
    if np.shape(arr) != want:
        raise _misfit(f"{np.shape(arr)} for {want}")
    if not torch.is_tensor(like):
        return [int(x) for x in np.reshape(arr, -1)]
    arr = np.ascontiguousarray(arr)
    if like.dtype == torch.bfloat16:
        if arr.dtype.itemsize != 2:
            raise _misfit(f"{arr.dtype} for bfloat16")
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if t.dtype != like.dtype:
        raise _misfit(f"{t.dtype} for {like.dtype}")
    t = t.to(device)
    return list(t.unbind(0)) if stacked else [t]


def deserialize_snapshot(data: bytes, template, layout, device=None):
    """Inverse of serialize_snapshot: (per-layer list of snapshots on
    `device`, n_tokens). `template` is a snapshot of this model's fresh
    state: it supplies the node types and the shapes every leaf must
    have. Raises ValueError for leaves that do not fit."""
    with np.load(io.BytesIO(data)) as z:
        n = int(z["n_tokens"])
        leaves = [np.array(z[f"leaf{i}"]) for i in range(len(z.files) - 1)]
    want = sum(len(snapshot_fields(template[layers[0]]))
               for _, layers, _ in layout)
    if len(leaves) != want:
        raise _misfit(f"{len(leaves)} leaves for {want}")
    out, it = [None] * len(template), iter(leaves)
    for _, layers, stacked in layout:
        tmpl = template[layers[0]]
        columns = [_from_host(next(it), like, device,
                              len(layers) if stacked else 0)
                   for like in snapshot_fields(tmpl)]
        for j, i in enumerate(layers):
            vals = [col[j] for col in columns]
            out[i] = vals[0] if torch.is_tensor(tmpl) else type(tmpl)(*vals)
    return out, n


# ---------------------------------------------------------------------------
# resumed-prefill bucketing
# ---------------------------------------------------------------------------

def bucket_chunks(pos0: int, end: int, block_size: int,
                  max_blocks: int | None = None) -> list[int]:
    """Split [pos0, end) into power-of-two multiples of block_size (largest
    first) plus one final sub-block tail; returns the absolute cut points
    (ascending, last == end).

    Every intermediate cut is block-aligned when pos0 is (the resume
    contract for block-granularity states). ``max_blocks`` caps every
    chunk at that many blocks (rounded down to a power of two, min 1): the
    serve scheduler uses it to keep each chunk under the per-tick prefill
    budget, so a long prompt becomes a run of equal budget-sized chunks,
    preemptible between every cut."""
    if end <= pos0:
        return []
    cap = None
    if max_blocks is not None:
        cap = 1 << (max(1, max_blocks).bit_length() - 1)
    m, t = divmod(end - pos0, block_size)
    cuts, pos = [], pos0
    while m:
        p = 1 << (m.bit_length() - 1)
        if cap is not None:
            p = min(p, cap)
        pos += p * block_size
        cuts.append(pos)
        m -= p
    if t:
        cuts.append(end)
    return cuts


# ---------------------------------------------------------------------------
# partial prefill: a schedulable in-flight prefill
# ---------------------------------------------------------------------------

class PartialPrefill(NamedTuple):
    """The carry of a chunked prefill, paused between chunks.

    state:    the model cache covering the first n_tokens tokens.
    n_tokens: host int; block-aligned at every pause point (only the final
              chunk may land off-grid, and then the prefill is complete).
    logits:   (1, V) last-position logits of the latest chunk (None before
              the first chunk lands).
    """
    state: object
    n_tokens: int
    logits: object = None

    @property
    def started(self) -> bool:
        return self.logits is not None


# ---------------------------------------------------------------------------
# the model-level facade
# ---------------------------------------------------------------------------

class DecodeState:
    """Uniform decode-state surface for one LM module (see
    models.transformer.LM). The protocol-level methods keep value
    semantics: a state passed in is left as it was."""

    def __init__(self, lm):
        self.lm = lm
        self.cfg = lm.cfg
        self.kinds = state_kinds(lm.cfg)
        self.layout = snapshot_layout(lm.cfg)
        for kind in self.kinds:
            get_spec(kind)          # raises for a kind the port lacks

    @property
    def kind(self) -> str:
        """The model's first state kind (a dense model has one)."""
        return self.kinds[0]

    @property
    def device(self) -> torch.device:
        return self.lm.embed.table.device

    # -- capabilities ------------------------------------------------------

    @property
    def block_size(self) -> int:
        """Snapshot / resumed-prefill grid (multiples of lt_block_size)."""
        return self.cfg.lt_block_size

    @property
    def snapshot_granularity(self) -> str | None:
        return composite_granularity(self.kinds)

    @property
    def resumable(self) -> bool:
        return all(get_spec(k).resumable for k in self.kinds)

    # -- lifecycle ---------------------------------------------------------

    def init(self, batch: int, max_len: int | None = None):
        return self.lm.init_cache(batch, max_len)

    def init_slot(self, max_len: int | None = None, *, whole: bool = False,
                  device=None):
        """Batch-1 cache for one serve slot: this rank's kv heads on a
        serving plan that splits them, all of them with `whole`."""
        return self.lm.init_slot_cache(max_len, whole=whole, device=device)

    def prefill(self, tokens, state=None, *, max_len=None, image_embeds=None):
        """tokens (B, S) -> (last-position logits (B, V), state).
        image_embeds (B, n_img, D): a VLM's, over the first n_img tokens."""
        if state is None:
            state = self.init(tokens.shape[0], max_len)
        return self.resume(tokens, state, 0, image_embeds=image_embeds)

    def resume(self, tokens, state, pos0: int, *, image_embeds=None):
        """Continue a prefill: `state` already covers the first pos0 tokens
        (block-aligned); this segment attends through it and positions run
        at the true absolute offsets. A kind that is not resumable takes
        pos0 == 0 only. An MoE model makes the reference's one call over
        the segment (its attention still runs block by block inside it):
        capacity couples the tokens of a call, so calls on the block grid
        would drop other tokens than the reference's call.

        image_embeds (B, n_img, D) belong to the absolute positions
        0..n_img-1 (a VLM's, with cfg.n_image_tokens set): each call gets
        the rows of its own positions, so the logits are the reference's
        one-call splice however the segment is cut. The prompt must reach
        n_img."""
        s = tokens.shape[1]
        if s == 0:
            raise ValueError("prefill needs at least one token")
        if not self.resumable and pos0:
            raise ValueError(f"a {'/'.join(self.kinds)!r} state is not "
                             f"resumable: its prefill starts at 0, got "
                             f"pos0={pos0}")
        n_img = 0
        if image_embeds is not None and self.cfg.n_image_tokens:
            n_img = image_embeds.shape[1]
            if pos0 + s < n_img:
                raise ValueError(f"{n_img} image embeddings do not fit a "
                                 f"prompt of {pos0 + s} tokens")
        start, logits = 0, None
        while start < s:
            if self.resumable and self.cfg.ffn != "moe":
                blk = self.block_size
                end = min(s, ((pos0 + start) // blk + 1) * blk - pos0)
            else:
                end = s
            positions = pos0 + start + torch.arange(end - start,
                                                    device=tokens.device)
            a = pos0 + start
            img = (image_embeds[:, a:min(pos0 + end, n_img)] if a < n_img
                   else None)
            logits, state = self.lm(tokens[:, start:end], mode="prefill",
                                    cache=state, positions=positions,
                                    image_embeds=img)
            start = end
        return logits[:, -1], state

    def decode_step(self, tok, pos, state, *, inplace: bool = False):
        """tok (B, 1) at position `pos`: an int shared by the batch, or a
        (B,) int64 tensor, one per row -> (logits (B, V), state).
        `inplace` writes into `state`'s buffers (an owner's state only)."""
        if torch.is_tensor(pos):
            positions = pos.reshape(-1, 1)
        else:
            positions = torch.full((1,), pos, dtype=torch.long,
                                   device=tok.device)
        logits, state = self.lm(tok, mode="decode", cache=state,
                                positions=positions, inplace=inplace)
        return logits[:, -1], state

    # -- snapshots ---------------------------------------------------------

    def snapshot(self, state):
        if self.snapshot_granularity is None:
            raise ValueError(
                f"decode state of {self.cfg.name!r} (kinds: "
                f"{'/'.join(self.kinds)}) has no constant-size snapshot")
        return snapshot_state(state)

    def restore(self, fresh_state, snapshot, n_tokens):
        return restore_state(fresh_state, snapshot, n_tokens)

    def snapshot_signature(self, max_len: int | None = None) -> list:
        """(shape, dtype) of each snapshot tensor, read from a fresh slot's
        state (no prefill runs): what a prefix cache binds to. A ring's
        window, min(sliding_window, max_len), is in it."""
        return [(tuple(x.shape), str(x.dtype)) for x in snapshot_tensors(
            self.snapshot(self.init_slot(max_len, whole=True, device="meta")))]

    def serialize(self, snapshot, n_tokens: int) -> bytes:
        return serialize_snapshot(snapshot, n_tokens, self.layout)

    def deserialize(self, data: bytes, max_len: int | None = None):
        """(snapshot, n_tokens) from serialize's bytes, checked leaf by leaf
        against a fresh slot's snapshot at `max_len` (ValueError if a leaf
        does not fit)."""
        template = self.snapshot(self.init_slot(max_len, whole=True))
        return deserialize_snapshot(data, template, self.layout, self.device)

    # -- partial prefill (chunked admission) -------------------------------

    def begin_partial(self, max_len: int | None = None) -> PartialPrefill:
        """A fresh, zero-token partial prefill (cold start)."""
        return PartialPrefill(self.init_slot(max_len), 0)

    def advance_partial(self, tokens, part: PartialPrefill) -> PartialPrefill:
        """Run one more chunk; tokens (1, S) continue at part.n_tokens."""
        logits, state = self.resume(tokens, part.state, part.n_tokens)
        return PartialPrefill(state, part.n_tokens + tokens.shape[1], logits)

    def partial_snapshot(self, part: PartialPrefill):
        """Constant-size snapshot of a paused prefill -> (snapshot, pos).
        Valid at block-grid pause points only (every pause point the
        scheduler produces)."""
        if part.n_tokens % self.block_size:
            raise ValueError(
                f"partial prefill paused off-grid ({part.n_tokens} tokens, "
                f"block {self.block_size}): not snapshotable")
        return self.snapshot(part.state), part.n_tokens

    def partial_restore(self, snapshot, n_tokens: int,
                        max_len: int | None = None) -> PartialPrefill:
        """Re-materialize a paused prefill from its snapshot (no logits
        yet: a pause point always has at least one chunk left to run)."""
        state = self.restore(self.init_slot(max_len), snapshot, n_tokens)
        return PartialPrefill(state, int(n_tokens))

    # -- slot stacking (continuous batching) -------------------------------

    @staticmethod
    def broadcast_slots(state, slots: int):
        return dec.broadcast_slot_caches(state, slots)

    @staticmethod
    def slot_scatter(slot_states, state, slot: int, *, inplace: bool = False):
        return dec.slot_scatter(slot_states, state, slot, inplace=inplace)

    @staticmethod
    def slot_gather(slot_states, slot: int):
        return dec.slot_gather(slot_states, slot)

    @staticmethod
    def slot_view(slot_states, slot: int, pos: int):
        return dec.slot_view(slot_states, slot, pos)
