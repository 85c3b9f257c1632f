"""Decoder-only transformer LM, dense family with polysketch, exact
polynomial or softmax attention.

Port of the dense ``block_pattern=("attn",)`` path of the JAX package's
``models/transformer.py`` (``lm_init``, ``lm_apply`` in train / prefill /
decode modes, ``lm_init_cache``, ``lm_init_slot_cache``). The JAX
``lax.scan`` over layer-stacked parameters is a Python loop over an
``nn.ModuleList`` with one module per block. MoE, SSD, RG-LRU and VLM
are not ported.

Each block: pre-norm -> mixer -> residual; pre-norm -> GLU FFN -> residual.

Rematerialisation (``cfg.remat``), as ``lm_apply`` checkpoints its group
body: in train mode with grad on, each group (here one block) runs under
``torch.utils.checkpoint``. ``"full"`` keeps only the block's input and
recomputes the rest in the backward (``jax.checkpoint``); ``"dots"`` also
keeps the outputs of the matrix products (``checkpoint_dots``). The
hand-written kernels are no products to the dispatcher (they write into
buffers through ctypes), so both policies run them again in the
backward, as ``checkpoint_dots`` recomputes a ``pallas_call``.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.state import get_spec, mixer_state_kind
from repro_torch.models.attention import MECHANISMS, Attention
from repro_torch.models.layers import GLUFFN, Embedding, Norm


REMAT = ("none", "dots", "full")


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
    if cfg.remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {cfg.remat!r}")


_aten = torch.ops.aten
# What `@`, einsum and F.linear reach at the dispatcher: the ops whose
# outputs "dots" keeps (jax's dot_general).
PRODUCT_OPS = frozenset((
    _aten.mm.default, _aten.bmm.default, _aten.addmm.default,
    _aten.baddbmm.default, _aten.addbmm.default, _aten.mv.default,
    _aten.addmv.default, _aten.dot.default, _aten.vdot.default))


def _save_products(ctx, op, *args, **kwargs):
    """The "dots" policy: keep every product's output, recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in PRODUCT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _run_block(remat, block, h, **kw):
    """block(h, **kw) with the activations kept as `remat` says. The
    blocks draw no random numbers, so no RNG state is stashed."""
    if remat == "none":
        return block(h, **kw)
    policy = {}
    if remat == "dots":
        policy["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_products)
    return checkpoint(block, h, use_reentrant=False, preserve_rng_state=False,
                      **policy, **kw)


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
        remat = (cfg.remat if mode == "train" and torch.is_grad_enabled()
                 else "none")
        for i, block in enumerate(self.layers):
            h, nc = _run_block(remat, block, h, positions=positions,
                               mode=mode,
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
