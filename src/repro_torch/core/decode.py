"""Decode-time attention state.

Port of two kinds of the JAX package's ``core/decode.py``:

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

`pos` is a host int (the JAX package keeps a device scalar): the fold and
the cache slot are decided on the host, with no device sync.

Caches are values, as in the reference: a step returns a new cache and
leaves the one it was given as it was, so buffers it writes are copies.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.utils import int_pow, self_kron


def _writable(buf: torch.Tensor) -> torch.Tensor:
    """A copy of a cache buffer for a step to write into."""
    return buf.clone()


class PolysketchCache(NamedTuple):
    z: torch.Tensor      # (B, Hkv, r^2, h+1) f32 prefix state over folded blocks
    kbuf: torch.Tensor   # (B, Hkv, b, h)     raw keys, current partial block
    vbuf: torch.Tensor   # (B, Hkv, b, h)
    mbuf: torch.Tensor   # (B, Hkv, b, r)     sketched keys, current partial block
    pos: int             # tokens consumed so far


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
                           local_exact: bool = True):
    """One decode step.

    qm: (B, Hq, r)  sketched query (input pre-scaled by sqrt(scale))
    km: (B, Hkv, r) sketched key
    q:  (B, Hq, h)  post-LN query;  k, v: (B, Hkv, h)
    Returns (out (B, Hq, h), new_cache). `cache` is left as it was, as in
    the reference: the token goes into copies of its buffers.
    """
    bsz, hq, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    blk = cache.kbuf.shape[2]
    fill = cache.pos % blk  # slot for the incoming token

    f32 = torch.float32
    kbuf, vbuf, mbuf = map(_writable, (cache.kbuf, cache.vbuf, cache.mbuf))
    kbuf[:, :, fill] = k.to(kbuf.dtype)
    vbuf[:, :, fill] = v.to(vbuf.dtype)
    mbuf[:, :, fill] = km.to(f32)

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
    w[..., fill + 1:] = 0.0
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
    if fill == blk - 1:
        kf = self_kron(mbuf)                                   # (B,Hkv,blk,r^2)
        z = z + torch.einsum("bnsf,bnsd->bnfd", kf, vv)
    new_cache = PolysketchCache(z=z, kbuf=kbuf, vbuf=vbuf, mbuf=mbuf,
                                pos=cache.pos + 1)
    return out.to(v.dtype), new_cache


def polysketch_prefill(cache: PolysketchCache, qm, km, q, k, v, *,
                       degree: int, scale: float, local_exact: bool = True):
    """Prefill one segment (B, H*, S, .) of a prompt into a PolysketchCache.

    The segment starts on the block grid (cache.pos % blk == 0, empty
    buffers) and is at most one block long; core.state.DecodeState cuts a
    prompt so. It attends through cache.z as if the folded tokens were
    part of this call, in one kernel launch (ops.polysketch_attention):
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


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, Hkv, S_max, h) post-RoPE, post-LN keys
    v: torch.Tensor   # (B, Hkv, S_max, h)
    pos: int          # tokens written so far


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


def _append_kv(cache: KVCache, k, v):
    """Copies of the cache's buffers with the token's k, v (B, Hkv, h)
    written at its position; returns (k, v, that position)."""
    pos = cache.pos
    if pos >= cache.k.shape[2]:
        raise ValueError(f"KV cache of {cache.k.shape[2]} is full at "
                         f"position {pos}")
    kc, vc = _writable(cache.k), _writable(cache.v)
    kc[:, :, pos] = k.to(kc.dtype)
    vc[:, :, pos] = v.to(vc.dtype)
    return kc, vc, pos


def poly_kv_decode_step(cache: KVCache, q, k, v, *, degree: int,
                        scale: float):
    """Exact polynomial attention decode over a full KV cache (the
    quadratic baseline; the paper's inference win is that polysketch does
    NOT need this). q: (B, Hq, h) post-LN; k: (B, Hkv, h) post-LN; v:
    (B, Hkv, h). Returns (out (B, Hq, h), new_cache); `cache` is left as it
    was."""
    bsz, hq, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    f32 = torch.float32
    kc, vc, pos = _append_kv(cache, k, v)
    qg = q.reshape(bsz, hkv, g, hd).to(f32)
    wts = int_pow(torch.einsum("bngh,bnsh->bngs", qg, kc.to(f32)) * scale,
                  degree)
    # every slot of the cache is scored; only 0..pos are live
    mask = torch.arange(kc.shape[2], device=kc.device) <= pos
    wts = torch.where(mask, wts, torch.zeros((), device=wts.device))
    den = 1.0 + wts.sum(-1, keepdim=True)
    out = torch.einsum("bngs,bnsh->bngh", wts / den, vc.to(f32))
    return out.reshape(bsz, hq, hd).to(v.dtype), KVCache(kc, vc, pos + 1)


def kv_decode_step(cache: KVCache, q, k, v):
    """One softmax decode step over a KV cache, scale 1/sqrt(h).

    q: (B, Hq, h); k, v: (B, Hkv, h). Every slot of the cache is scored and
    the slots past `pos` are masked; query heads are grouped onto their kv
    head (GQA). Returns (out (B, Hq, h), new_cache); `cache` is left as it
    was."""
    bsz, hq, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    f32 = torch.float32
    kc, vc, pos = _append_kv(cache, k, v)
    qg = q.reshape(bsz, hkv, g, hd).to(f32)
    logits = torch.einsum("bngh,bnsh->bngs", qg, kc.to(f32)) * (1.0 / hd ** 0.5)
    idx = torch.arange(kc.shape[2], device=kc.device)
    logits = logits.masked_fill(idx > pos, torch.finfo(f32).min)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngs,bnsh->bngh", w, vc.to(f32))
    return out.reshape(bsz, hq, hd).to(v.dtype), KVCache(kc, vc, pos + 1)
