"""Decode-time state: attention caches and the recurrent mixers' nodes.

Port of the JAX package's ``core/decode.py``:

- polysketch: the constant-size ``PolysketchCache`` (an r^2 x (h+1)
  prefix matrix per kv head plus one partial-block buffer), its prefill
  and its decode step. A token attends exactly (degree-p weights) to the
  tokens of its own block so far, and through the sketched prefix state
  to every earlier, completed block. When the buffer fills, the whole
  block is folded into the state.
- poly_kv: the full ``KVCache`` of exact polynomial attention (the
  paper's quadratic baseline), filled by the prefill and read whole by
  ``poly_kv_decode_step``.
- kv_full: the same ``KVCache`` for softmax attention (the paper's
  softmax baseline), read by ``kv_decode_step``.
- kv_ring: the sliding-window ``RingKVCache`` of local attention (the
  last W tokens' post-RoPE k and v at slot pos % W), its decode step and
  its resumable prefill on a fixed sub-block lattice (``ring_grid``).
- ssd and rglru: the position-free ``RecurrentCache`` (the exact
  recurrent state h after every token so far, in f32, and the conv's
  trailing inputs), built and stepped by ``models/ssm.py`` and
  ``models/rglru.py``.

`pos` takes two forms:
- a host int shared by the batch (``generate`` and every prefill): the
  fold and the cache slot are decided on the host, with no device sync;
- a (B,) int64 tensor on the device, one position per row (the serve
  engine's slot-stacked state, where each slot sits at its own depth).
  Every row writes at its own slot and masks its own live positions; the
  polysketch fold is computed for every row and kept, with
  ``torch.where``, only where that row's block completes (the reference's
  ``lax.cond`` under the engine's ``vmap`` over slots), so a row that
  does not fold keeps its state bit for bit. A KV write past the cache
  clamps to its last slot, as JAX's ``dynamic_update_index_in_dim`` does
  (only a free slot decoding along on stale state gets there); a ring
  write wraps at pos % W.

Caches are values, as in the reference: a step returns a new cache and
leaves the one it was given as it was, so buffers it writes are copies.
``inplace=True`` writes into the given buffers instead (the engine owns
its slot-stacked state, as the reference donates it).

The slot helpers (``broadcast_slot_caches``, ``slot_scatter``,
``slot_gather``) stack serve slots on the batch axis of a model cache (a
list of per-layer nodes), not on a new leading axis: a batch-1 cache goes
in and comes out.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.utils import int_pow, pad_to_multiple, self_kron


def _writable(buf: torch.Tensor, inplace: bool = False) -> torch.Tensor:
    """The cache buffer a step writes into: a copy, or itself."""
    return buf if inplace else buf.clone()


def _rows(pos, bsz, device):
    """Batch-row indices for a per-row write, or None for a shared pos."""
    return torch.arange(bsz, device=device) if torch.is_tensor(pos) else None


def _write_at(buf, rows, idx, x):
    """buf[:, :, idx] = x for a shared int idx, or buf[b, :, idx[b]] = x[b]
    for every row b (idx a (B,) tensor); x is (B, H, d)."""
    if rows is None:
        buf[:, :, idx] = x
    else:
        buf[rows, :, idx] = x


def _live(n, last, device):
    """Mask of positions 0..last over n slots: (n,) for a shared int,
    (B, 1, 1, n) for a (B,) tensor (broadcasts over heads and queries)."""
    idx = torch.arange(n, device=device)
    if not torch.is_tensor(last):
        return idx <= last
    return (idx[None, :] <= last[:, None])[:, None, None, :]


class PolysketchCache(NamedTuple):
    z: torch.Tensor      # (B, Hkv, r^2, h+1) f32 prefix state over folded blocks
    kbuf: torch.Tensor   # (B, Hkv, b, h)     raw keys, current partial block
    vbuf: torch.Tensor   # (B, Hkv, b, h)
    mbuf: torch.Tensor   # (B, Hkv, b, r)     sketched keys, current partial block
    pos: int | torch.Tensor  # tokens consumed so far (int, or (B,) per row)


def init_polysketch_cache(batch, n_kv_heads, head_dim, r, block_size,
                          dtype=torch.float32, device="cpu") -> PolysketchCache:
    b = block_size
    z = lambda *s, dt=dtype: torch.zeros(s, dtype=dt, device=device)  # noqa: E731
    return PolysketchCache(
        z=z(batch, n_kv_heads, r * r, head_dim + 1, dt=torch.float32),
        kbuf=z(batch, n_kv_heads, b, head_dim),
        vbuf=z(batch, n_kv_heads, b, head_dim),
        mbuf=z(batch, n_kv_heads, b, r, dt=torch.float32),
        pos=0,
    )


def polysketch_decode_step(cache: PolysketchCache, qm, km, q, k, v, *,
                           degree: int, scale: float,
                           local_exact: bool = True, inplace: bool = False):
    """One decode step.

    qm: (B, Hq, r)  sketched query (input pre-scaled by sqrt(scale))
    km: (B, Hkv, r) sketched key
    q:  (B, Hq, h)  post-LN query;  k, v: (B, Hkv, h)
    Returns (out (B, Hq, h), new_cache). `cache` is left as it was, as in
    the reference, unless `inplace`: the token goes into copies of its
    buffers.
    """
    bsz, hq, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    blk = cache.kbuf.shape[2]
    fill = cache.pos % blk  # slot for the incoming token (int or (B,))
    rows = _rows(fill, bsz, q.device)

    f32 = torch.float32
    kbuf, vbuf, mbuf = (_writable(b, inplace)
                        for b in (cache.kbuf, cache.vbuf, cache.mbuf))
    _write_at(kbuf, rows, fill, k.to(kbuf.dtype))
    _write_at(vbuf, rows, fill, v.to(vbuf.dtype))
    _write_at(mbuf, rows, fill, km.to(f32))

    # --- local (within current partial block) attention weights ---
    qg = q.reshape(bsz, hkv, g, hd).to(f32)
    qmg = qm.reshape(bsz, hkv, g, -1).to(f32)
    if local_exact:
        w = int_pow(torch.einsum("bngh,bnsh->bngs", qg, kbuf.to(f32)) * scale,
                    degree)
    else:
        w = torch.einsum("bngr,bnsr->bngs", qmg, mbuf)
        w = w * w
    # slots past `fill` hold zeros or a stale block; only 0..fill are live
    w = torch.where(_live(blk, fill, q.device), w, 0.0)
    ones = vbuf.new_ones((*vbuf.shape[:-1], 1), dtype=f32)
    vv = torch.cat([vbuf.to(f32), ones], dim=-1)               # (B,Hkv,blk,h+1)
    local = torch.einsum("bngs,bnsd->bngd", w, vv)

    # --- sketched prefix (folded blocks) ---
    qf = self_kron(qmg)                                        # (B,Hkv,g,r^2)
    cross = torch.einsum("bngf,bnfd->bngd", qf, cache.z)

    acc = local + cross
    out = (acc[..., :hd] / (1.0 + acc[..., hd:])).reshape(bsz, hq, hd)

    # --- fold the block into the prefix state when it completes ---
    z = cache.z
    if rows is not None or fill == blk - 1:
        kf = self_kron(mbuf)                                   # (B,Hkv,blk,r^2)
        folded = z + torch.einsum("bnsf,bnsd->bnfd", kf, vv)
        z = (folded if rows is None else
             torch.where((fill == blk - 1)[:, None, None, None], folded, z))
    new_cache = PolysketchCache(z=z, kbuf=kbuf, vbuf=vbuf, mbuf=mbuf,
                                pos=cache.pos + 1)
    return out.to(v.dtype), new_cache


def polysketch_prefill(cache: PolysketchCache, qm, km, q, k, v, *,
                       degree: int, scale: float, local_exact: bool = True):
    """Prefill one segment (B, H*, S, .) of a prompt into a PolysketchCache.

    The segment starts on the block grid (cache.pos % blk == 0, empty
    buffers) and is at most one block long; core.state.DecodeState cuts a
    prompt so (inside an MoE model's one call, polysketch_prefill_blocks
    does). It attends through cache.z as if the folded tokens were part of
    this call, in one kernel launch (ops.polysketch_attention):
    - a full block (S == blk) is folded: the kernel returns the new state,
      added to z0 in order, so a prefill resumed at a block boundary is
      bit-identical to a cold prefill of the whole prompt;
    - a shorter segment is the prompt's tail. It runs as one block of its
      own length and is NOT folded: it lives in the buffers until decode
      completes the block.
    Returns (outputs (B, Hq, S, h), cache). `cache` is left as it was.
    """
    bsz, hkv, s, hd = k.shape
    g = q.shape[1] // hkv
    blk = cache.kbuf.shape[2]
    if cache.pos % blk or s > blk:
        raise ValueError(f"a prefill segment starts on the block grid and "
                         f"spans at most one block of {blk}; got pos "
                         f"{cache.pos}, length {s}")
    f32 = torch.float32
    out = ops.polysketch_attention(
        qm, km, q, k, v, degree=degree, scale=scale, local_exact=local_exact,
        block_size=s, z0=cache.z, return_state=s == blk)
    if s == blk:
        out, z_r = out
        # all g query-head copies of a kv head folded one block from one
        # z0, so any copy is the per-kv-head state
        z = z_r.reshape(bsz, hkv, g, *z_r.shape[2:])[:, :, 0].contiguous()
        return out, cache._replace(z=z, pos=cache.pos + s)
    kbuf, vbuf, mbuf = map(_writable, (cache.kbuf, cache.vbuf, cache.mbuf))
    kbuf[:, :, :s] = k.to(kbuf.dtype)
    vbuf[:, :, :s] = v.to(vbuf.dtype)
    mbuf[:, :, :s] = km.to(f32)
    return out, cache._replace(kbuf=kbuf, vbuf=vbuf, mbuf=mbuf,
                               pos=cache.pos + s)


def polysketch_prefill_blocks(cache: PolysketchCache, qm, km, q, k, v, **kw):
    """A segment of any length that starts on the block grid, through
    polysketch_prefill one block at a time (one kernel launch each), the
    outputs joined: the block-grid calls' attention inside one model call
    (an MoE model's, whose capacity couples the tokens of a call)."""
    blk, s = cache.kbuf.shape[2], q.shape[2]
    if s <= blk:
        return polysketch_prefill(cache, qm, km, q, k, v, **kw)
    outs = []
    for a in range(0, s, blk):
        y, cache = polysketch_prefill(cache, qm[:, :, a:a + blk], km[:, :, a:a + blk],
                                      q[:, :, a:a + blk], k[:, :, a:a + blk],
                                      v[:, :, a:a + blk], **kw)
        outs.append(y)
    return torch.cat(outs, dim=2), cache


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, Hkv, S_max, h) post-RoPE, post-LN keys
    v: torch.Tensor   # (B, Hkv, S_max, h)
    pos: int | torch.Tensor  # tokens written so far (int, or (B,) per row)


def init_kv_cache(batch, n_kv_heads, head_dim, max_len, dtype=torch.float32,
                  device="cpu") -> KVCache:
    shape = (batch, n_kv_heads, max_len, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), pos=0)


def fill_kv(cache: KVCache, k, v) -> KVCache:
    """The prefill's keys and values (B, Hkv, S, h), written at position
    0 of copies of the cache's buffers (the reference's ``_fill_kv``)."""
    s = k.shape[2]
    if s > cache.k.shape[2]:
        raise ValueError(f"a prompt of {s} tokens does not fit a KV cache "
                         f"of {cache.k.shape[2]}")
    kc, vc = _writable(cache.k), _writable(cache.v)
    kc[:, :, :s] = k.to(kc.dtype)
    vc[:, :, :s] = v.to(vc.dtype)
    return KVCache(kc, vc, s)


def _append_kv(cache: KVCache, k, v, inplace: bool = False):
    """The cache's buffers (copies unless `inplace`) with the token's k, v
    (B, Hkv, h) written at its position; returns (k, v, that position).
    A per-row position past the cache clamps to its last slot, as JAX's
    dynamic_update_index_in_dim does."""
    pos, s_max = cache.pos, cache.k.shape[2]
    rows = _rows(pos, k.shape[0], k.device)
    if rows is None:
        if pos >= s_max:
            raise ValueError(f"KV cache of {s_max} is full at position {pos}")
        idx = pos
    else:
        idx = pos.clamp(max=s_max - 1)
    kc, vc = _writable(cache.k, inplace), _writable(cache.v, inplace)
    _write_at(kc, rows, idx, k.to(kc.dtype))
    _write_at(vc, rows, idx, v.to(vc.dtype))
    return kc, vc, pos


def poly_kv_decode_step(cache: KVCache, q, k, v, *, degree: int,
                        scale: float, inplace: bool = False):
    """Exact polynomial attention decode over a full KV cache (the
    quadratic baseline; the paper's inference win is that polysketch does
    NOT need this). q: (B, Hq, h) post-LN; k: (B, Hkv, h) post-LN; v:
    (B, Hkv, h). Returns (out (B, Hq, h), new_cache); `cache` is left as it
    was unless `inplace`."""
    bsz, hq, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    f32 = torch.float32
    kc, vc, pos = _append_kv(cache, k, v, inplace)
    qg = q.reshape(bsz, hkv, g, hd).to(f32)
    wts = int_pow(torch.einsum("bngh,bnsh->bngs", qg, kc.to(f32)) * scale,
                  degree)
    # every slot of the cache is scored; only 0..pos are live
    mask = _live(kc.shape[2], pos, kc.device)
    wts = torch.where(mask, wts, torch.zeros((), device=wts.device))
    den = 1.0 + wts.sum(-1, keepdim=True)
    out = torch.einsum("bngs,bnsh->bngh", wts / den, vc.to(f32))
    return out.reshape(bsz, hq, hd).to(v.dtype), KVCache(kc, vc, pos + 1)


def kv_decode_step(cache: KVCache, q, k, v, *, inplace: bool = False):
    """One softmax decode step over a KV cache, scale 1/sqrt(h).

    q: (B, Hq, h); k, v: (B, Hkv, h). Every slot of the cache is scored and
    the slots past `pos` are masked; query heads are grouped onto their kv
    head (GQA). Returns (out (B, Hq, h), new_cache); `cache` is left as it
    was unless `inplace`."""
    bsz, hq, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    f32 = torch.float32
    kc, vc, pos = _append_kv(cache, k, v, inplace)
    qg = q.reshape(bsz, hkv, g, hd).to(f32)
    logits = torch.einsum("bngh,bnsh->bngs", qg, kc.to(f32)) * (1.0 / hd ** 0.5)
    logits = torch.where(_live(kc.shape[2], pos, kc.device), logits,
                         torch.finfo(f32).min)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngs,bnsh->bngh", w, vc.to(f32))
    return out.reshape(bsz, hq, hd).to(v.dtype), KVCache(kc, vc, pos + 1)


# ---------------------------------------------------------------------------
# recurrent state (ssd, rglru) and the sliding-window ring (kv_ring)
# ---------------------------------------------------------------------------

class RecurrentCache(NamedTuple):
    """Constant-size recurrent decode state (SSD / RG-LRU mixers).

    There is no partial-block buffer: `h` is the exact state after every
    token consumed so far, so the state is valid at any position (token
    granularity), and bit-reproducible at the lt_block_size grid the
    prefill scans run on. The node is position-free: the engine tracks
    positions."""
    h: torch.Tensor     # (B, ...) f32 (SSD: (B, H, N, P); RG-LRU: (B, W))
    conv: torch.Tensor  # (B, K-1, C) trailing conv inputs, compute dtype


def recurrent_update(cache: RecurrentCache, h, conv,
                     inplace: bool = False) -> RecurrentCache:
    """A decode step's new state: new tensors, or written into `cache`'s
    own buffers when `inplace` (the engine's state)."""
    if not inplace:
        return RecurrentCache(h=h, conv=conv)
    cache.h.copy_(h)
    cache.conv.copy_(conv)
    return cache


class RingKVCache(NamedTuple):
    """Sliding-window ring KV state (local_attn mixers): the last
    min(pos, W) tokens' post-RoPE k and v at slot = absolute_pos % W, a
    constant-size O(W) state and so a token-granularity snapshot (the
    append-only KVCache has none). A type of its own, as core.state
    dispatches snapshot ops by node type."""
    k: torch.Tensor   # (B, Hkv, W, h)
    v: torch.Tensor   # (B, Hkv, W, h)
    pos: int | torch.Tensor  # tokens written so far (int, or (B,) per row)


def init_ring_cache(batch, n_kv_heads, head_dim, window, dtype=torch.float32,
                    device="cpu") -> RingKVCache:
    shape = (batch, n_kv_heads, window, head_dim)
    return RingKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device), pos=0)


def kv_ring_decode_step(cache: RingKVCache, q, k, v, *,
                        scale: float | None = None, inplace: bool = False):
    """Sliding-window softmax decode over a ring of W slots. The ring holds
    post-RoPE keys, so its rotation leaves relative positions alone. Each
    row writes at slot pos % W and attends over the slots 0..pos (all W
    once the ring is full). q: (B, Hq, h); k, v: (B, Hkv, h). Returns
    (out (B, Hq, h), new_cache); `cache` is left as it was unless
    `inplace`."""
    bsz, hq, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / float(hd) ** 0.5
    f32 = torch.float32
    w = cache.k.shape[2]
    pos = cache.pos
    slot = pos % w
    rows = _rows(pos, bsz, q.device)
    kc, vc = _writable(cache.k, inplace), _writable(cache.v, inplace)
    _write_at(kc, rows, slot, k.to(kc.dtype))
    _write_at(vc, rows, slot, v.to(vc.dtype))
    qg = q.reshape(bsz, hkv, g, hd).to(f32)
    logits = torch.einsum("bngh,bnsh->bngs", qg, kc.to(f32)) * scale
    logits = torch.where(_live(w, pos, q.device), logits, torch.finfo(f32).min)
    wts = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngs,bnsh->bngh", wts, vc.to(f32))
    return (out.reshape(bsz, hq, hd).to(v.dtype),
            RingKVCache(kc, vc, pos + 1))


def ring_grid(block_size: int, window: int) -> int:
    """Sub-block lattice of the kv_ring prefill: the largest divisor of the
    resume grid (lt_block_size) that fits the ring. Dividing the block
    keeps any block-aligned resume on the cold prefill's lattice; fitting
    the ring keeps one sub-block's writes on distinct slots."""
    g = min(block_size, window)
    while block_size % g:
        g -= 1
    return g


def kv_ring_prefill(cache: RingKVCache, q, k, v, *, grid: int,
                    scale: float | None = None):
    """Sliding-window softmax prefill resuming from a ring cache.

    q: (B, Hq, S, h); k, v: (B, Hkv, S, h), post-RoPE, at absolute
    positions cache.pos .. cache.pos + S - 1 (cache.pos a host int on the
    `grid` lattice). Returns (out (B, Hq, S, h), new RingKVCache covering
    cache.pos + S tokens); `cache` is left as it was.

    The segment runs in `grid`-token sub-blocks anchored at absolute
    position 0, padded to whole sub-blocks: each attends its queries over
    [ring (W), sub-block (grid)] with fixed shapes and masks that depend
    only on its base position, then writes its live tokens' k and v at
    ring slots (base + i) % W (padded positions write nothing: their
    slots may still hold live older tokens). Every sub-block's arithmetic
    is thus independent of where the call started, and a prefill resumed
    from a snapshot at a lattice cut equals the cold prefill bit for bit.
    """
    bsz, hq, s, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    w = cache.k.shape[2]
    if grid > w:
        raise ValueError(f"grid({grid}) must be <= ring window({w})")
    if torch.is_tensor(cache.pos) or cache.pos % grid:
        raise ValueError(f"a ring prefill starts at a host-int position on "
                         f"its {grid}-token lattice, got {cache.pos}")
    if scale is None:
        scale = 1.0 / float(hd) ** 0.5
    f32 = torch.float32
    dev = q.device
    nb = -(-s // grid)
    q, k, v = (pad_to_multiple(x, grid, 2)[0] for x in (q, k, v))
    rk, rv = _writable(cache.k), _writable(cache.v)
    i = torch.arange(grid, device=dev)
    t = torch.arange(w, device=dev)
    loc = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
    outs = []
    for j in range(nb):
        base = cache.pos + j * grid
        nv = min(s - j * grid, grid)
        p = base + i                                   # absolute query pos
        # latest absolute position written to ring slot t (negative if
        # never written): the value in [base - W, base - 1] congruent to t
        abs_t = base - w + torch.remainder(t - base, w)
        ring_ok = (abs_t[None, :] >= 0) & (abs_t[None, :] > p[:, None] - w)
        mask = torch.cat([ring_ok, loc & (i[None, :] < nv)], dim=1)
        sl = slice(j * grid, (j + 1) * grid)
        kj, vj = k[:, :, sl].to(rk.dtype), v[:, :, sl].to(rv.dtype)
        kcat = torch.cat([rk, kj], dim=2).to(f32)
        vcat = torch.cat([rv, vj], dim=2).to(f32)
        qg = q[:, :, sl].reshape(bsz, hkv, g, grid, hd).to(f32)
        logits = torch.einsum("bngqh,bnkh->bngqk", qg, kcat) * scale
        logits = torch.where(mask, logits, torch.finfo(f32).min)
        wts = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bngqk,bnkh->bngqh", wts, vcat))
        slots = torch.remainder(p[:nv], w)             # distinct: grid <= W
        rk[:, :, slots] = kj[:, :, :nv]
        rv[:, :, slots] = vj[:, :, :nv]
    out = torch.stack(outs, dim=3)                     # (B,Hkv,g,nb,grid,h)
    out = out.reshape(bsz, hq, nb * grid, hd)[:, :, :s]
    return out.to(v.dtype), RingKVCache(rk, rv, cache.pos + s)


# ---------------------------------------------------------------------------
# slot stacking (continuous batching)
# ---------------------------------------------------------------------------

def _node_map(fn_tensor, fn_pos, *nodes):
    """Map a per-layer cache node field by field: `fn_pos` on `pos`,
    `fn_tensor` on every buffer."""
    first = nodes[0]
    return type(first)(*(
        fn_pos(*vals) if name == "pos" else fn_tensor(*vals)
        for name, *vals in zip(first._fields, *nodes)))


def broadcast_slot_caches(cache, slots: int):
    """Replicate a batch-1 model cache (a list of per-layer nodes) into
    `slots` rows of the batch axis; the shared int `pos` becomes a (slots,)
    int64 tensor, so each slot carries its own position."""
    def rep(x):
        return x.expand(slots, *x.shape[1:]).clone()

    def pos(p):
        dev = cache[0][0].device
        return torch.full((slots,), int(p), dtype=torch.int64, device=dev)
    return [_node_map(rep, pos, node) for node in cache]


def slot_scatter(slot_caches, cache, slot: int, *, inplace: bool = False):
    """Write a batch-1 model cache into row `slot` of the slot-stacked one.
    Returns the new stack (`slot_caches` left as it was, unless `inplace`).
    The write is device-side: the batch-1 cache's int `pos` goes in by a
    fill."""
    def put(full, one):
        full = _writable(full, inplace)
        full[slot].copy_(one[0])
        return full

    def pos(full, one):
        full = _writable(full, inplace)
        full[slot].fill_(int(one))
        return full
    return [_node_map(put, pos, full, one)
            for full, one in zip(slot_caches, cache)]


def slot_gather(slot_caches, slot: int):
    """Row `slot` of the slot-stacked cache as a batch-1 model cache (copies),
    with its `pos` as a host int (this reads the position back: one sync)."""
    return [_node_map(lambda x: x[slot:slot + 1].clone(),
                      lambda p: int(p[slot]), node) for node in slot_caches]


def slot_view(slot_caches, slot: int, pos: int):
    """Row `slot` of the slot-stacked cache as a batch-1 model cache of
    views (no copy, no sync), at the position `pos` the caller knows: for
    a reader that copies what it keeps (a snapshot, slot_scatter) before
    the stack is written again."""
    return [_node_map(lambda x: x[slot:slot + 1], lambda p: int(pos), node)
            for node in slot_caches]
