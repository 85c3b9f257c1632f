"""Attention mixer in train, prefill and decode modes, for the paper's
knob ``cfg.attention``: "polysketch" or "polynomial" (exact, quadratic).

Port of those two branches of the JAX package's ``models/attention.py``
(``attention_init``, ``_project``, ``_poly_ln``, ``_out``,
``attention_apply``, ``_fill_kv``). Parameter names and layouts are the
reference's: wq (d, Hq, h), wk/wv (d, Hkv, h), wo (Hq, h, d), the q/k
LayerNorm's pln_*, and for polysketch only the learned sketch.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core import decode as dec
from repro_torch.core.poly_attention import qk_layernorm
from repro_torch.core.sketches import init_sketch, sketch_half
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rope
from repro_torch.utils import const_param, normal_param


MECHANISMS = ("polysketch", "polynomial")


class Attention(nn.Module):
    def __init__(self, cfg, *, generator=None, device="cpu"):
        super().__init__()
        if cfg.attention not in MECHANISMS:
            raise NotImplementedError(
                f"the port serves {' and '.join(MECHANISMS)} attention, "
                f"got {cfg.attention!r}")
        if cfg.qk_norm:
            raise NotImplementedError("qk_norm is not ported")
        self.cfg = cfg
        d, hq, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        hd = cfg.resolved_head_dim
        kw = dict(generator=generator, device=device)
        self.wq = dense_init(d, (hq, hd), **kw)
        self.wk = dense_init(d, (hkv, hd), **kw)
        self.wv = dense_init(d, (hkv, hd), **kw)
        self.wo = normal_param((hq, hd, d), 1.0 / math.sqrt(hq * hd), **kw)
        # Paper S2.1: LayerNorm on q/k before the polynomial.
        self.pln_q_scale = const_param((hd,), 1.0, device=device)
        self.pln_k_scale = const_param((hd,), 1.0, device=device)
        self.pln_q_bias = const_param((hd,), 0.0, device=device)
        self.pln_k_bias = const_param((hd,), 0.0, device=device)
        if cfg.attention == "polysketch":
            self.sketch = init_sketch(hd, cfg.sketch_size, cfg.poly_degree,
                                      cfg.learned_sketch, **kw)

    def _project(self, x, positions):
        """x: (B, S, D) -> q (B,Hq,S,h), k,v (B,Hkv,S,h) with RoPE applied."""
        dt = x.dtype
        bsz, s, d = x.shape

        def proj(w):
            y = x @ w.to(dt).reshape(d, -1)
            return y.reshape(bsz, s, w.shape[1], w.shape[2]).transpose(1, 2)

        q, k, v = proj(self.wq), proj(self.wk), proj(self.wv)
        if self.cfg.use_rope:
            q = rope(q, positions, self.cfg.rope_theta)
            k = rope(k, positions, self.cfg.rope_theta)
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
        """y: (B, Hq, S, h) -> (B, S, D)."""
        bsz, hq, s, hd = y.shape
        y = y.transpose(1, 2).reshape(bsz, s, hq * hd)
        return y @ self.wo.to(y.dtype).reshape(hq * hd, -1)

    def init_cache(self, batch: int, max_len: int | None, dtype, device):
        """A PolysketchCache (constant size; max_len sizes nothing), or a
        KVCache of max_len positions for polynomial attention."""
        cfg = self.cfg
        hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        if cfg.attention == "polynomial":
            if max_len is None:
                raise ValueError(
                    "a KV cache is sized at init: prefill needs max_len "
                    "(or a pre-built state)")
            return dec.init_kv_cache(batch, hkv, hd, max_len, dtype, device)
        return dec.init_polysketch_cache(
            batch, hkv, hd, cfg.sketch_size, cfg.lt_block_size, dtype, device)

    def forward(self, x, *, positions, mode: str, cache=None):
        """Returns (y (B,S,D), new_cache_or_None)."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        q, k, v = self._project(x, positions)
        if self.cfg.attention == "polynomial":
            return self._polynomial(q, k, v, mode, cache)
        return self._polysketch(q, k, v, mode, cache)

    def _polynomial(self, q, k, v, mode, cache):
        cfg = self.cfg
        kw = dict(degree=cfg.poly_degree, scale=cfg.attn_scale)
        q, k = self._poly_ln(q, k)
        if mode == "decode":
            y, cache = dec.poly_kv_decode_step(
                cache, q[:, :, 0], k[:, :, 0], v[:, :, 0], **kw)
            return self._out(y[:, :, None]), cache
        y = ops.poly_attention(q, k, v, causal=True, **kw)
        if mode == "prefill":
            cache = dec.fill_kv(cache, k, v)
        return self._out(y), cache

    def _polysketch(self, q, k, v, mode, cache):
        cfg = self.cfg
        kw = dict(degree=cfg.poly_degree, scale=cfg.attn_scale,
                  local_exact=cfg.local_exact)
        if mode == "decode":
            q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]   # (B, H, h)
            q, k = self._poly_ln(q, k)
            y, cache = dec.polysketch_decode_step(
                cache, self._sketch(q), self._sketch(k), q, k, v, **kw)
            return self._out(y[:, :, None]), cache
        q, k = self._poly_ln(q, k)
        qm, km = self._sketch(q), self._sketch(k)
        if mode == "prefill":
            y, cache = dec.polysketch_prefill(cache, qm, km, q, k, v, **kw)
        else:
            y = ops.polysketch_attention(
                qm, km, q, k, v, block_size=min(cfg.lt_block_size, q.shape[-2]),
                **kw)
        return self._out(y), cache
