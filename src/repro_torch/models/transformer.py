"""Decoder-only transformer LM, dense family with polysketch, exact
polynomial or softmax attention.

Port of the dense ``block_pattern=("attn",)`` path of the JAX package's
``models/transformer.py`` (``lm_init``, ``lm_apply`` in train / prefill /
decode modes, ``lm_init_cache``, ``lm_init_slot_cache``). The JAX
``lax.scan`` over layer-stacked parameters is a Python loop over an
``nn.ModuleList`` with one module per block. MoE, SSD, RG-LRU and VLM
are not ported.

Each block: pre-norm -> mixer -> residual; pre-norm -> GLU FFN -> residual.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core.state import get_spec, mixer_state_kind
from repro_torch.models.attention import MECHANISMS, Attention
from repro_torch.models.layers import GLUFFN, Embedding, Norm


def check_supported(cfg):
    """Raise for a config outside the port's slice."""
    if cfg.family != "dense" or tuple(cfg.block_pattern) != ("attn",) \
            or cfg.ffn != "glu" or cfg.attention not in MECHANISMS:
        raise NotImplementedError(
            f"{cfg.name!r}: the port covers the dense family (block_pattern "
            f"('attn',), GLU FFN) with {', '.join(MECHANISMS)} attention "
            f"only")
    if not cfg.tie_embeddings:
        raise NotImplementedError("untied embeddings are not ported")
    if cfg.d_ff <= 0:
        raise NotImplementedError("mixer-only blocks are not ported")
    if cfg.remat != "none":
        raise NotImplementedError(f"remat={cfg.remat!r} is not ported; the "
                                  "port trains with remat='none'")


class Block(nn.Module):
    def __init__(self, cfg, *, generator=None, device="cpu"):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.norm1 = Norm(cfg.d_model, cfg.norm, device=device)
        self.norm2 = Norm(cfg.d_model, cfg.norm, device=device)
        self.mixer = Attention(cfg, **kw)
        self.ffn = GLUFFN(cfg.d_model, cfg.d_ff, **kw)

    def forward(self, h, *, positions, mode, cache=None, inplace=False):
        y, new_cache = self.mixer(self.norm1(h), positions=positions,
                                  mode=mode, cache=cache, inplace=inplace)
        h = h + y
        h = h + self.ffn(self.norm2(h))
        return h, new_cache


class LM(nn.Module):
    """The LM's parameters and forward. Parameter `layers.{i}.<path>` is
    the JAX leaf `groups/block0/<path>` at layer index i."""

    def __init__(self, cfg, *, generator=None, device="cpu"):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.layers = nn.ModuleList(Block(cfg, **kw)
                                    for _ in range(cfg.n_layers))
        self.final_norm = Norm(cfg.d_model, cfg.norm, device=device)

    def forward(self, tokens, *, mode: str = "train", cache=None,
                positions=None, inplace: bool = False):
        """tokens: (B, S) int (S == 1 for decode). positions: (S,) shared
        by the batch, or (B, S) one row each (decode at per-slot depths).

        Returns (logits (B, S, V), new_cache): the cache is None in train
        mode, else a list with one cache per layer. `inplace` lets a decode
        step write into `cache`'s buffers (the engine's own state).
        """
        cfg = self.cfg
        dt = getattr(torch, cfg.compute_dtype)
        table = self.embed.table.to(dt)
        h = table[tokens] * math.sqrt(cfg.d_model)
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        new_cache = None if mode == "train" else []
        for i, block in enumerate(self.layers):
            h, nc = block(h, positions=positions, mode=mode,
                          cache=None if cache is None else cache[i],
                          inplace=inplace)
            if new_cache is not None:
                new_cache.append(nc)
        h = self.final_norm(h)
        logits = h @ table.t()
        return logits, new_cache

    def init_cache(self, batch: int, max_len: int | None = None):
        """Decode cache, one node per layer, built by the state kind's
        registry entry (core.state): a constant-size PolysketchCache
        (`max_len` sizes nothing), or a KVCache of `max_len` positions for
        polynomial and softmax attention (required then)."""
        spec = get_spec(mixer_state_kind(self.cfg))
        dt = getattr(torch, self.cfg.compute_dtype)
        dev = self.embed.table.device
        return [spec.init(self.cfg, batch, max_len, dt, dev)
                for _ in self.layers]

    def init_slot_cache(self, max_len: int | None = None):
        """Decode cache for one serve slot: batch 1 with a host-int `pos`
        (core.decode.broadcast_slot_caches stacks slots on the batch axis
        and gives each its own position)."""
        return self.init_cache(1, max_len)
