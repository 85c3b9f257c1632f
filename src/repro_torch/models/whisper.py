"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

Port of the JAX package's ``models/whisper.py`` (``whisper_init``,
``whisper_encode``, ``whisper_decode``, ``whisper_init_cache``). As in
the reference, the conv/mel frontend is a stub: the caller supplies
precomputed frame embeddings ``frames`` (B, encoder_len, d_model). The
encoder is a bidirectional softmax transformer over the frames plus
sinusoidal positions; the decoder is a causal LM whose self-attention is
the configured mechanism (the paper's polysketch in whisper-large-v3),
plus softmax cross-attention over the encoder's memory, with no
positional embedding of any kind (``use_rope=False``) and logits tied to
the embedding table.

    encoder block:  norm1 -> encoder_attn -> residual; norm2 -> GLU -> residual
    decoder block:  norm1 -> attn (self) -> residual; norm_x -> cross_attn
                    -> residual; norm2 -> GLU -> residual

Parameters: ``embed.table``, ``enc.{i}.<path>`` and ``dec.{i}.<path>``
(one module a layer; the reference stacks each over its layers as
``enc/<path>`` and ``dec/<path>``, see ``bridge``), ``enc_norm`` and
``dec_norm``.

The decode cache is a list with one node a decoder layer, ``{"self": the
self-attention's state (a PolysketchCache), "cross": a KVCache of the
memory's projected k and v}``; a prefill builds "cross" from the memory,
a decode step reads it. The model has no ``DecodeState``: the slot
machinery carries no encoder state, so ``generate`` and ``ServeEngine``
refuse it, as the reference's do, and ``serve.engine.make_serve_fns``
serves it.

Rematerialisation as the reference has it: whenever ``cfg.remat`` is
"dots" or "full" the reference wraps the encoder's layer body in a plain
``jax.checkpoint`` (whatever the mode) and the decoder's in train mode,
so Whisper's "dots" rematerialises fully: here each block runs under
``torch.utils.checkpoint`` with no policy, in both cases, when grad is
on.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core import decode as dec
from repro_torch.core.state import get_spec, mixer_state_kind
from repro_torch.distributed.sharding import shard_act
from repro_torch.models.attention import Attention
from repro_torch.models.layers import (GLUFFN, Embedding, Norm,
                                       sinusoidal_positions)
from repro_torch.models.transformer import REMAT, _run_block


class EncoderBlock(nn.Module):
    def __init__(self, cfg, *, generator=None, device="cpu"):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.norm1 = Norm(cfg.d_model, cfg.norm, device=device)
        self.attn = Attention(cfg, "encoder_attn", **kw)
        self.norm2 = Norm(cfg.d_model, cfg.norm, device=device)
        self.ffn = GLUFFN(cfg.d_model, cfg.d_ff, **kw)

    def forward(self, h, *, positions):
        h = shard_act(h, "batch", "seq", "embed")
        y, _ = self.attn(self.norm1(h), positions=positions, mode="train")
        h = h + y
        return h + self.ffn(self.norm2(h))


class DecoderBlock(nn.Module):
    def __init__(self, cfg, *, generator=None, device="cpu"):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.norm1 = Norm(cfg.d_model, cfg.norm, device=device)
        self.self_attn = Attention(cfg, "attn", **kw)
        self.norm_x = Norm(cfg.d_model, cfg.norm, device=device)
        self.cross_attn = Attention(cfg, "cross_attn", **kw)
        self.norm2 = Norm(cfg.d_model, cfg.norm, device=device)
        self.ffn = GLUFFN(cfg.d_model, cfg.d_ff, **kw)

    def forward(self, h, *, positions, mode, cache=None, memory=None,
                inplace=False):
        """Returns (h, the layer's new cache node: None in train mode)."""
        h = shard_act(h, "batch", "seq", "embed")
        self_cache = None if cache is None else cache["self"]
        cross_cache = None if cache is None else cache["cross"]
        y, new_self = self.self_attn(self.norm1(h), positions=positions,
                                     mode=mode, cache=self_cache,
                                     inplace=inplace)
        h = h + y
        y, _ = self.cross_attn(self.norm_x(h), positions=positions, mode=mode,
                               cache=cross_cache, memory=memory)
        h = h + y
        h = h + self.ffn(self.norm2(h))
        if mode == "train":
            return h, None
        cross = (self.cross_attn.cross_cache(memory, h.dtype)
                 if mode == "prefill" else cross_cache)
        return h, {"self": new_self, "cross": cross}


class Whisper(nn.Module):
    """The encoder-decoder's parameters, ``encode``, ``decode`` and
    ``init_cache``; ``forward`` is the reference Model's ``apply``."""

    def __init__(self, cfg, *, generator=None, device="cpu"):
        super().__init__()
        if cfg.family != "audio":
            raise ValueError(f"{cfg.name!r} is no encoder-decoder "
                             f"(family {cfg.family!r})")
        if cfg.remat not in REMAT:
            raise ValueError(f"remat must be one of {REMAT}, got {cfg.remat!r}")
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.enc = nn.ModuleList(EncoderBlock(cfg, **kw)
                                 for _ in range(cfg.encoder_layers))
        self.dec = nn.ModuleList(DecoderBlock(cfg, **kw)
                                 for _ in range(cfg.n_layers))
        self.enc_norm = Norm(cfg.d_model, cfg.norm, device=device)
        self.dec_norm = Norm(cfg.d_model, cfg.norm, device=device)

    def _remat(self) -> str:
        """"full" when the reference checkpoints ("dots" or "full") and grad
        is on, else "none"."""
        on = self.cfg.remat in ("dots", "full") and torch.is_grad_enabled()
        return "full" if on else "none"

    def encode(self, frames):
        """frames: (B, T, D) precomputed frame embeddings -> the memory
        (B, T, D) in the compute dtype."""
        cfg = self.cfg
        dt = getattr(torch, cfg.compute_dtype)
        t = frames.shape[1]
        h = frames.to(dt) + sinusoidal_positions(
            t, cfg.d_model, device=frames.device).to(dt)
        positions = torch.arange(t, device=frames.device)
        remat = self._remat()
        for block in self.enc:
            h = _run_block(remat, block, h, positions=positions)
        return self.enc_norm(h)

    def decode(self, tokens, memory=None, *, mode: str = "train", cache=None,
               positions=None, inplace: bool = False):
        """tokens: (B, S); memory: (B, T, D), required unless a decode step
        reads the cache. Returns (logits (B, S, V), new_cache: None in
        train mode, else one node a decoder layer)."""
        cfg = self.cfg
        dt = getattr(torch, cfg.compute_dtype)
        table = self.embed.table.to(dt)
        h = table[tokens] * math.sqrt(cfg.d_model)
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        remat = self._remat() if mode == "train" else "none"
        new_cache = None if mode == "train" else []
        for i, block in enumerate(self.dec):
            h, nc = _run_block(remat, block, h, positions=positions, mode=mode,
                               cache=None if cache is None else cache[i],
                               memory=memory, inplace=inplace)
            if new_cache is not None:
                new_cache.append(nc)
        h = self.dec_norm(h)
        return h @ table.t(), new_cache

    def forward(self, tokens, *, frames=None, mode: str = "train", cache=None,
                positions=None, inplace: bool = False,
                return_aux: bool = False):
        """The reference Model's apply: train and prefill encode `frames`
        and decode against the memory; a decode step reads the cache's.
        Returns (logits, new_cache), with return_aux (logits, new_cache, {})."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        memory = None
        if mode != "decode":
            if frames is None:
                raise ValueError(f"Whisper's {mode} needs the encoder's frames")
            memory = self.encode(frames)
        logits, new_cache = self.decode(tokens, memory, mode=mode, cache=cache,
                                        positions=positions, inplace=inplace)
        return (logits, new_cache, {}) if return_aux else (logits, new_cache)

    def init_cache(self, batch: int, max_len: int | None = None):
        """One node a decoder layer: the self-attention's state of its kind
        (a PolysketchCache for whisper-large-v3; `max_len` sizes a KV
        kind's) and a zero KVCache of encoder_len positions for the
        cross-attention (a prefill replaces it)."""
        cfg = self.cfg
        dt = getattr(torch, cfg.compute_dtype)
        dev = self.embed.table.device
        spec = get_spec(mixer_state_kind(cfg, "attn"))
        return [{"self": spec.init(cfg, batch, max_len, dt, dev),
                 "cross": dec.init_kv_cache(batch, cfg.n_heads,
                                            cfg.resolved_head_dim,
                                            cfg.encoder_len, dt, dev)}
                for _ in self.dec]
