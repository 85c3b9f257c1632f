"""Attention mixers in train, prefill and decode modes: the global
``kind="attn"`` for the paper's knob ``cfg.attention`` ("polysketch",
"polynomial" (exact, quadratic) or "softmax", the baseline), the
sliding-window ``kind="local_attn"`` (softmax over the last
cfg.sliding_window tokens, whatever cfg.attention says; recurrentgemma),
and Whisper's two softmax kinds: ``"encoder_attn"`` (bidirectional, over
the encoder's frames) and ``"cross_attn"`` (the decoder's queries over
the encoder's memory, its projected k and v kept in a ``KVCache``).

Port of the JAX package's ``models/attention.py`` (``attention_init``,
``_project``, ``_poly_ln``, ``_out``, ``attention_apply``, ``_fill_kv``,
``_cross_attention``, ``cross_attention_cache``). Parameter names and
layouts are the reference's: wq (d, Hq, h), wk/wv (d, Hkv, h), wo (Hq, h,
d), with ``cfg.qk_norm`` the per-head q/k RMS norms' q_norm and k_norm
(h,), for the two polynomial mechanisms of "attn" the q/k LayerNorm's
pln_*, and for polysketch only the learned sketch. The encoder and cross
kinds are multi-head (Hkv = Hq, as published) and apply no RoPE;
``noncausal_polysketch``, which no model calls, is not ported.

Over a "model" mesh axis of M ranks (``distributed.tensor_parallel``)
each rank projects and attends over its own Hq/M query and Hkv/M kv
heads (wq/wk/wv hold its block: the training state and a serving plan
place them so), and the heads meet at
the reference's gather point "act_heads" before ``_out``: gathered whole
under the serving rules, then contracted with the whole wo; kept split
under the training rules, contracted with this rank's rows of wo and
summed over "model" (the input's gradient summed in the backward).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core import decode as dec
from repro_torch.core.poly_attention import (qk_layernorm,
                                              sliding_attention_blocked,
                                              softmax_attention_full)
from repro_torch.core.sketches import init_sketch, sketch_half
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import shard_act
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rms, rope
from repro_torch.utils import const_param, normal_param


MECHANISMS = ("polysketch", "polynomial", "softmax")
KINDS = ("attn", "local_attn", "encoder_attn", "cross_attn")


class Attention(nn.Module):
    def __init__(self, cfg, kind: str = "attn", *, generator=None,
                 device="cpu"):
        super().__init__()
        if kind not in KINDS:
            raise NotImplementedError(f"attention kind {kind!r} is not "
                                      f"ported (the port has {KINDS})")
        if kind == "attn" and cfg.attention not in MECHANISMS:
            raise NotImplementedError(
                f"the port serves {', '.join(MECHANISMS)} attention, "
                f"got {cfg.attention!r}")
        self.cfg = cfg
        self.kind = kind
        # the other kinds are softmax whatever the knob says
        self.mech = cfg.attention if kind == "attn" else "softmax"
        d, hq, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        if kind in ("encoder_attn", "cross_attn"):
            hkv = hq          # MHA for encoder/cross per the published whisper arch
        hd = cfg.resolved_head_dim
        kw = dict(generator=generator, device=device)
        self.wq = dense_init(d, (hq, hd), **kw)
        self.wk = dense_init(d, (hkv, hd), **kw)
        self.wv = dense_init(d, (hkv, hd), **kw)
        self.wo = normal_param((hq, hd, d), 1.0 / math.sqrt(hq * hd), **kw)
        if cfg.qk_norm:   # per-head RMS norms of q and k (qwen3)
            self.q_norm = const_param((hd,), 1.0, device=device)
            self.k_norm = const_param((hd,), 1.0, device=device)
        if self.mech != "softmax":
            # Paper S2.1: LayerNorm on q/k before the polynomial.
            self.pln_q_scale = const_param((hd,), 1.0, device=device)
            self.pln_k_scale = const_param((hd,), 1.0, device=device)
            self.pln_q_bias = const_param((hd,), 0.0, device=device)
            self.pln_k_bias = const_param((hd,), 0.0, device=device)
        if self.mech == "polysketch":
            self.sketch = init_sketch(hd, cfg.sketch_size, cfg.poly_degree,
                                      cfg.learned_sketch, **kw)

    @staticmethod
    def _proj(x, w):
        """x (B, S, D) @ w (D, H, h) -> (B, H, S, h) in x's dtype."""
        bsz, s, d = x.shape
        y = x @ w.to(x.dtype).reshape(d, -1)
        return y.reshape(bsz, s, w.shape[1], w.shape[2]).transpose(1, 2)

    def _project(self, x, positions):
        """x: (B, S, D) -> q (B,Hq,S,h), k,v (B,Hkv,S,h): q/k RMS-normed per
        head when cfg.qk_norm, then RoPE applied (attn and local_attn).
        Over "model": this rank's heads."""
        if tp.keeps("act_heads"):
            x = tp.enter(x)
        q, k, v = (self._proj(x, w) for w in (self.wq, self.wk, self.wv))
        if self.cfg.qk_norm:
            q, k = rms(q, self.q_norm), rms(k, self.k_norm)
        if self.cfg.use_rope and self.kind in ("attn", "local_attn"):
            q = rope(q, positions, self.cfg.rope_theta)
            k = rope(k, positions, self.cfg.rope_theta)
        q = shard_act(q, "batch", "q_heads", "seq", "head_dim")
        k = shard_act(k, "batch", "kv_heads", "seq", "head_dim")
        v = shard_act(v, "batch", "kv_heads", "seq", "head_dim")
        return q, k, v

    def _poly_ln(self, q, k):
        q = qk_layernorm(q, self.pln_q_scale, self.pln_q_bias)
        k = qk_layernorm(k, self.pln_k_scale, self.pln_k_bias)
        return q, k

    def _sketch(self, x):
        cfg = self.cfg
        return sketch_half(self.sketch, x * math.sqrt(cfg.attn_scale),
                           cfg.poly_degree, cfg.learned_sketch)

    def _out(self, y):
        """y: (B, Hq, S, h) -> (B, S, D). The heads contract at the gather
        point "act_heads": whole under the serving rules, this rank's
        rows of wo and a sum over "model" under the training rules."""
        y = shard_act(y, "batch", "act_heads")
        bsz, hq, s, hd = y.shape
        y = y.transpose(1, 2).reshape(bsz, s, hq * hd)
        out = y @ self.wo.to(y.dtype).reshape(hq * hd, -1)
        return tp.reduce(out) if tp.keeps("act_heads") else out

    def forward(self, x, *, positions, mode: str, cache=None,
                inplace: bool = False, memory=None):
        """Returns (y (B,S,D), new_cache_or_None). positions: (S,), or
        (B, S) per row; `inplace` lets a decode step write into `cache`'s
        buffers instead of copies. `memory` (B, T, D): the encoder output a
        cross_attn mixer attends to; without it, the KVCache `cache` of
        its projected k and v (returned as it came)."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        if self.kind == "cross_attn":
            return self._cross(x, cache, memory), cache
        q, k, v = self._project(x, positions)
        if self.kind == "encoder_attn":
            y = softmax_attention_full(q, k, v, causal=False)
            return self._out(y), None
        if self.kind == "local_attn":
            return self._local(q, k, v, mode, cache, inplace)
        if self.mech == "polynomial":
            return self._polynomial(q, k, v, mode, cache, inplace)
        if self.mech == "softmax":
            return self._softmax(q, k, v, mode, cache, inplace)
        return self._polysketch(q, k, v, mode, cache, inplace)

    def _cross(self, x, cache, memory):
        """Softmax over the encoder memory (scale 1/sqrt(h), no mask), the
        queries unnormed and unroped, as the reference's
        ``_cross_attention``."""
        q = self._proj(x, self.wq)
        if memory is not None:
            k, v = self._proj(memory, self.wk), self._proj(memory, self.wv)
        else:
            k, v = cache.k, cache.v
        return self._out(softmax_attention_full(q, k, v, causal=False))

    def cross_cache(self, memory, dtype) -> dec.KVCache:
        """The KVCache of the memory's projected k and v (B, H, T, h), cast
        to `dtype`, full (pos T): the reference's ``cross_attention_cache``,
        which a prefill builds for the decode steps after it."""
        k, v = self._proj(memory, self.wk), self._proj(memory, self.wv)
        return dec.KVCache(k.to(dtype), v.to(dtype), k.shape[2])

    def _local(self, q, k, v, mode, cache, inplace):
        """Sliding-window softmax, scale 1/sqrt(h): the ring's decode step,
        its resumable prefill on the ring_grid lattice, and in train mode
        the blocked band with the kv heads repeated onto the query heads."""
        cfg = self.cfg
        if mode == "decode":
            y, cache = dec.kv_ring_decode_step(cache, q[:, :, 0], k[:, :, 0],
                                               v[:, :, 0], inplace=inplace)
            return self._out(y[:, :, None]), cache
        if mode == "prefill":
            y, cache = dec.kv_ring_prefill(
                cache, q, k, v,
                grid=dec.ring_grid(cfg.lt_block_size, cache.k.shape[2]))
            return self._out(y), cache
        g = q.shape[1] // k.shape[1]
        kr = k.repeat_interleave(g, dim=1) if g > 1 else k
        vr = v.repeat_interleave(g, dim=1) if g > 1 else v
        y = sliding_attention_blocked(q, kr, vr, window=cfg.sliding_window)
        return self._out(y), None

    def _softmax(self, q, k, v, mode, cache, inplace):
        """Plain ops, as the reference computes it (scale 1/sqrt(h), not
        cfg.attn_scale; no q/k LayerNorm)."""
        if mode == "decode":
            y, cache = dec.kv_decode_step(cache, q[:, :, 0], k[:, :, 0],
                                          v[:, :, 0], inplace=inplace)
            return self._out(y[:, :, None]), cache
        g = q.shape[1] // k.shape[1]
        kr = k.repeat_interleave(g, dim=1) if g > 1 else k
        vr = v.repeat_interleave(g, dim=1) if g > 1 else v
        y = softmax_attention_full(q, kr, vr, causal=True)
        if mode == "prefill":
            cache = dec.fill_kv(cache, k, v)
        return self._out(y), cache

    def _polynomial(self, q, k, v, mode, cache, inplace):
        cfg = self.cfg
        kw = dict(degree=cfg.poly_degree, scale=cfg.attn_scale)
        q, k = self._poly_ln(q, k)
        if mode == "decode":
            y, cache = dec.poly_kv_decode_step(
                cache, q[:, :, 0], k[:, :, 0], v[:, :, 0], inplace=inplace,
                **kw)
            return self._out(y[:, :, None]), cache
        y = ops.poly_attention(q, k, v, causal=True, **kw)
        if mode == "prefill":
            cache = dec.fill_kv(cache, k, v)
        return self._out(y), cache

    def _polysketch(self, q, k, v, mode, cache, inplace):
        cfg = self.cfg
        kw = dict(degree=cfg.poly_degree, scale=cfg.attn_scale,
                  local_exact=cfg.local_exact)
        if mode == "decode":
            q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]   # (B, H, h)
            q, k = self._poly_ln(q, k)
            y, cache = dec.polysketch_decode_step(
                cache, self._sketch(q), self._sketch(k), q, k, v,
                inplace=inplace, **kw)
            return self._out(y[:, :, None]), cache
        q, k = self._poly_ln(q, k)
        qm, km = self._sketch(q), self._sketch(k)
        if mode == "prefill":
            y, cache = dec.polysketch_prefill_blocks(cache, qm, km, q, k, v, **kw)
        else:
            y = ops.polysketch_attention(
                qm, km, q, k, v, block_size=min(cfg.lt_block_size, q.shape[-2]),
                **kw)
        return self._out(y), cache
