"""Decoder-only LM: the dense family (polysketch, exact polynomial or
softmax attention), the recurrent families (mamba2's SSD blocks,
recurrentgemma's (rglru, rglru, local_attn) pattern), the
mixture-of-experts family (dbrx, llama4-maverick) and the VLM
(llava-next-mistral-7b: precomputed image embeddings over the first
tokens). The encoder-decoder family is ``models/whisper.py``'s.

Port of the JAX package's ``models/transformer.py`` (``effective_pattern``
as ``layer_kinds``, ``lm_init``, ``lm_apply`` in train / prefill / decode
modes with its summed aux losses, ``lm_init_cache``,
``lm_init_slot_cache``). Layers cycle through the config's effective
pattern of (mixer, FFN) pairs, of length lcm(len(block_pattern),
moe_period); the reference stacks each pattern position over the groups
and runs the groups under ``lax.scan``, then an unscanned tail of
n_layers % len(pattern) blocks. Here every layer is its own module in an
``nn.ModuleList``, looped over in order: layer i is group i // g, block
i % g, and the tail follows (``bridge`` maps the two layouts).

The embedding: the table's rows times sqrt(d_model); with
``image_embeds`` (B, n_img, D) and ``cfg.n_image_tokens`` set, the first
n_img rows are the image embeddings instead, unscaled (the anyres
frontend is a stub in the reference too). The logits: h against the
table (tied), or h @ ``lm_head`` (d_model, vocab) with
``tie_embeddings=False``. Trained over a "model" axis (the rows of the
table and of an untied lm_head split by vocab), the lookup and the logits
are vocab-parallel (``distributed.tensor_parallel``); served with an
lm_head placed by vocab, the logits are gathered whole.

Each block: pre-norm -> mixer -> residual; pre-norm -> FFN -> residual.
The mixer is attn (the paper's knob), local_attn (a sliding window),
rglru or ssd; the FFN a GLU or an MoE (``models/moe.py``, every
moe_period-th layer). A mixer-only block (d_ff == 0: mamba2) has no
second norm and no FFN. In train mode each MoE block returns its router
aux losses, which the LM sums over the layers (``_zero_aux`` /
``_add_aux``) for the train step; prefill and decode do not compute them.

Rematerialisation (``cfg.remat``), as ``lm_apply`` checkpoints its group
body: in train mode with grad on, each group (here one block) runs under
``torch.utils.checkpoint``. ``"full"`` keeps only the block's input and
recomputes the rest in the backward (``jax.checkpoint``); ``"dots"`` also
keeps the outputs of the matrix products (``checkpoint_dots``). The
hand-written kernels are no products to the dispatcher (they write into
buffers through ctypes), so both policies run them again in the
backward, as ``checkpoint_dots`` recomputes a ``pallas_call``. The aux
losses are outputs of the checkpointed function, so their gradient
reaches the router through the recomputation. The recomputation runs
where autograd runs the backward (on CUDA a thread of its own), so it
re-activates the thread-local contexts the forward ran under (the mesh
and rules, the rows' split: ``tensor_parallel.thread_state``); without
them a block split over "model" would recompute without its
collectives.
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import effective_pattern
from repro_torch.core.state import get_spec, mixer_state_kind
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import shard_act
from repro_torch.models.attention import MECHANISMS, Attention
from repro_torch.models.layers import GLUFFN, Embedding, Norm
from repro_torch.models.moe import MoE
from repro_torch.models.rglru import RGLRU
from repro_torch.models.ssm import SSM
from repro_torch.utils import normal_param


REMAT = ("none", "dots", "full")
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
FFNS = ("glu", "moe")
MIXERS = ("attn", "local_attn", "rglru", "ssd")


def check_supported(cfg):
    """Raise for a config the LM does not build: an unknown family, FFN,
    block-pattern mixer or attention mechanism, and the encoder-decoder
    family, which ``models.whisper.Whisper`` builds."""
    if cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.name!r}: the audio family is an encoder-decoder, built by "
            f"models/whisper.py (model_zoo.build_model), not by the LM")
    if cfg.family not in FAMILIES or cfg.ffn not in FFNS:
        raise NotImplementedError(
            f"{cfg.name!r}: family {cfg.family!r} with a {cfg.ffn!r} FFN is "
            f"not ported; the LM covers the {', '.join(FAMILIES)} families "
            f"with {' or '.join(FFNS)} FFNs")
    unknown = [m for m in cfg.block_pattern if m not in MIXERS]
    if unknown or not cfg.block_pattern:
        raise NotImplementedError(
            f"{cfg.name!r}: mixers {unknown} are no LM block mixers (the LM "
            f"has {', '.join(MIXERS)}; encoder and cross attention are "
            f"models/whisper.py's)")
    if "attn" in cfg.block_pattern and cfg.attention not in MECHANISMS:
        raise NotImplementedError(
            f"{cfg.name!r}: {cfg.attention!r} attention is not ported (the "
            f"port has {', '.join(MECHANISMS)})")
    if cfg.remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {cfg.remat!r}")


def layer_kinds(cfg) -> list[tuple[str, str]]:
    """The (mixer, ffn) kinds of every layer, groups then tail: the
    reference's effective pattern, repeated."""
    pattern = effective_pattern(cfg)
    return [pattern[i % len(pattern)] for i in range(cfg.n_layers)]


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


@contextlib.contextmanager
def _recompute(ctx, state):
    with ctx, tp.thread_state_active(state):
        yield


def _run_block(remat, block, h, **kw):
    """block(h, **kw) with the activations kept as `remat` says, the
    recomputation under this thread's contexts. The blocks draw no random
    numbers, so no RNG state is stashed."""
    if remat == "none":
        return block(h, **kw)
    state = tp.thread_state()

    def contexts():
        if remat == "dots":
            fwd, rec = create_selective_checkpoint_contexts(_save_products)
        else:
            fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
        return fwd, _recompute(rec, state)
    return checkpoint(block, h, use_reentrant=False, preserve_rng_state=False,
                      context_fn=contexts, **kw)


class Block(nn.Module):
    def __init__(self, cfg, mixer: str = "attn", ffn: str = "glu", *,
                 generator=None, device="cpu"):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.kind, self.ffn_kind = mixer, ffn
        self.norm1 = Norm(cfg.d_model, cfg.norm, device=device)
        if mixer in ("attn", "local_attn"):
            self.mixer = Attention(cfg, mixer, **kw)
        elif mixer == "rglru":
            self.mixer = RGLRU(cfg, **kw)
        else:
            self.mixer = SSM(cfg, **kw)
        if ffn == "moe":
            self.norm2 = Norm(cfg.d_model, cfg.norm, device=device)
            self.ffn = MoE(cfg, **kw)
        elif cfg.d_ff > 0:
            self.norm2 = Norm(cfg.d_model, cfg.norm, device=device)
            self.ffn = GLUFFN(cfg.d_model, cfg.d_ff, **kw)
        else:                                # mixer-only block (mamba2)
            self.norm2 = self.ffn = None

    def forward(self, h, *, positions, mode, cache=None, inplace=False):
        """Returns (h, the mixer's new cache, the MoE's aux losses: {}
        for a GLU or no FFN, and outside train mode)."""
        h = shard_act(h, "batch", "seq", "embed")
        y, new_cache = self.mixer(self.norm1(h), positions=positions,
                                  mode=mode, cache=cache, inplace=inplace)
        h = h + y
        aux = {}
        if self.ffn_kind == "moe":
            y, aux = self.ffn(self.norm2(h), with_aux=mode == "train")
            h = h + y
        elif self.ffn is not None:
            h = h + self.ffn(self.norm2(h))
        return h, new_cache, aux


def _zero_aux(cfg, device) -> dict[str, torch.Tensor]:
    if cfg.ffn == "moe":
        return {k: torch.zeros((), dtype=torch.float32, device=device)
                for k in ("load_balance", "router_z")}
    return {}


def _add_aux(acc, aux):
    for k, v in aux.items():
        acc[k] = acc[k] + v
    return acc


def _held_heads(cfg, mixer):
    """`cfg` cut to the q and kv heads an attention mixer's weights hold."""
    if not isinstance(mixer, Attention) or mixer.wq.shape[1] == cfg.n_heads:
        return cfg
    return cfg.replace(n_heads=mixer.wq.shape[1], n_kv_heads=mixer.wk.shape[1],
                       head_dim=cfg.resolved_head_dim)


class LM(nn.Module):
    """The LM's parameters and forward. Parameter `layers.{i}.<path>` is
    the JAX leaf `groups/block{i % g}/<path>` at group i // g, or in the
    tail `tail/block{b}/<path>` (see bridge)."""

    def __init__(self, cfg, *, generator=None, device="cpu"):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.layers = nn.ModuleList(Block(cfg, mixer, ffn, **kw)
                                    for mixer, ffn in layer_kinds(cfg))
        self.final_norm = Norm(cfg.d_model, cfg.norm, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = normal_param((cfg.d_model, cfg.vocab_size), 0.02,
                                        **kw)

    def forward(self, tokens, *, mode: str = "train", cache=None,
                positions=None, inplace: bool = False,
                return_aux: bool = False, image_embeds=None):
        """tokens: (B, S) int (S == 1 for decode). positions: (S,) shared
        by the batch, or (B, S) one row each (decode at per-slot depths).
        image_embeds: (B, n_img, D), n_img <= S, spliced over the first
        n_img rows of the embedding when cfg.n_image_tokens is set (a
        shorter prompt raises).

        Returns (logits (B, S, V), new_cache): the cache is None in train
        mode, else a list with one cache per layer. `inplace` lets a decode
        step write into `cache`'s buffers (the engine's own state). With
        return_aux, (logits, new_cache, aux): the MoE layers' router aux
        losses summed over the layers ({} without MoE; zeros outside train
        mode), the reference's third output.
        """
        cfg = self.cfg
        dt = getattr(torch, cfg.compute_dtype)
        table = self.embed.table.to(dt)
        vocab_split = tp.splits("vocab", cfg.vocab_size)
        if vocab_split:
            # this rank's vocab rows (training over "model")
            h = tp.vocab_parallel_lookup(table, tokens) * math.sqrt(cfg.d_model)
        else:
            h = table[tokens] * math.sqrt(cfg.d_model)
        if image_embeds is not None and cfg.n_image_tokens:
            n_img = image_embeds.shape[1]
            if n_img > h.shape[1]:
                raise ValueError(f"{n_img} image embeddings do not fit a "
                                 f"prompt of {h.shape[1]} tokens")
            h = torch.cat([image_embeds.to(dt), h[:, n_img:]], dim=1)
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        new_cache = None if mode == "train" else []
        remat = (cfg.remat if mode == "train" and torch.is_grad_enabled()
                 else "none")
        aux_total = _zero_aux(cfg, h.device)
        for i, block in enumerate(self.layers):
            h, nc, aux = _run_block(remat, block, h, positions=positions,
                                    mode=mode,
                                    cache=None if cache is None else cache[i],
                                    inplace=inplace)
            aux_total = _add_aux(aux_total, aux)
            if new_cache is not None:
                new_cache.append(nc)
        h = self.final_norm(h)
        w = table.t() if cfg.tie_embeddings else self.lm_head.to(dt)
        if vocab_split:
            # training: this rank's vocab columns, the loss vocab-parallel
            logits = tp.enter(h) @ w
        elif not cfg.tie_embeddings and tp.gathers_vocab(cfg.vocab_size):
            # serving: an lm_head placed by vocab, gathered (the
            # reference's constrain_logits)
            logits = tp.gather(h @ w, -1)
        else:
            logits = h @ w
        if return_aux:
            return logits, new_cache, aux_total
        return logits, new_cache

    def init_cache(self, batch: int, max_len: int | None = None, *,
                   whole: bool = False, device=None):
        """Decode cache, one node per layer, each built by its mixer's state
        kind's registry entry (core.state): a constant-size PolysketchCache
        or RecurrentCache (`max_len` sizes nothing), a RingKVCache of
        min(sliding_window, max_len) slots, or a KVCache of `max_len`
        positions for polynomial and softmax attention (required then).
        An attention state holds the heads its mixer's wq/wk hold (a
        rank's block once a serving plan placed them), all of them with
        `whole`."""
        cfg = self.cfg
        dt = getattr(torch, cfg.compute_dtype)
        dev = self.embed.table.device if device is None else device
        return [get_spec(mixer_state_kind(cfg, block.kind)).init(
                    cfg if whole else _held_heads(cfg, block.mixer), batch, max_len, dt, dev)
                for block in self.layers]

    def init_slot_cache(self, max_len: int | None = None, **kw):
        """Decode cache for one serve slot: batch 1 with a host-int `pos`
        (core.decode.broadcast_slot_caches stacks slots on the batch axis
        and gives each its own position)."""
        return self.init_cache(1, max_len, **kw)
