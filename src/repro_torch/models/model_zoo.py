"""Model facade of the port: ``build_model(cfg, device=)`` and
``input_specs(cfg, shape)``.

Port of the JAX package's ``models/model_zoo.py``: for the decoder-only
LMs (dense, recurrent, mixture-of-experts and the VLM) the LM module
(which holds the parameters) and its ``DecodeState``; for the audio
family the encoder-decoder ``models.whisper.Whisper`` with no
DecodeState (``state`` None), as the reference gives it none. A served
model is frozen and in eval mode; with ``trainable=True`` every
parameter takes a gradient except a random sketch's projection ``g``,
which the reference keeps frozen with ``stop_gradient``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.state import DecodeState
from repro_torch.models.transformer import LM
from repro_torch.models.whisper import Whisper
from repro_torch.utils import resolve_device


@dataclass
class Model:
    cfg: object
    lm: LM | Whisper
    state: DecodeState | None      # None: not servable through the engine

    @property
    def device(self) -> torch.device:
        return self.lm.embed.table.device

    def axes(self) -> dict[str, tuple]:
        """{parameter name: logical axis names}, the reference's axes tree
        from ``model.init`` leaf for leaf (param_axes)."""
        return param_axes(self.lm)


def build_model(cfg, *, device=None, seed: int = 0,
                params: dict[str, torch.Tensor] | None = None,
                trainable: bool = False, draw_on_device: bool = False) -> Model:
    """Build the LM (a Whisper for the audio family) on `device`
    (default cuda; raises with no card).

    Weights are drawn from a CPU torch.Generator seeded with `seed`, with
    the reference's init distributions, so a seed gives the same weights
    on every device; on the meta device nothing is drawn. With
    draw_on_device, from a generator on `device` seeded with `seed`
    instead: billions of weights in seconds (a CPU draw of a 14B model
    takes minutes of host time and its size in host memory), the same for
    a seed on that device type, but other values than the CPU draw.
    `params` (a state dict, e.g. from bridge.params_from_jax) replaces
    them. trainable: train mode, gradients on (the random sketch's g
    excepted); otherwise eval mode with every parameter frozen.
    """
    dev = (torch.device("meta") if device == "meta"
           else resolve_device(device))
    gen = torch.Generator(device=dev if draw_on_device else "cpu").manual_seed(seed)
    audio = cfg.family == "audio"
    lm = (Whisper if audio else LM)(cfg, generator=gen, device=dev)
    if params is not None:
        lm.load_state_dict(params, strict=True)
    lm.train(trainable)
    for name, p in lm.named_parameters():
        p.requires_grad_(trainable and not _frozen(name))
    return Model(cfg, lm, None if audio else DecodeState(lm))


def _frozen(name: str) -> bool:
    """A random sketch projection (RandomProjection.g): frozen in training."""
    return name.endswith(".g")


def input_specs(cfg, shape, *, for_train: bool | None = None
                ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of every model input of a shape cell, as the
    reference's ``input_specs``: train tokens (B, S+1) (the step shifts
    them), prefill tokens (B, S), decode tokens (B, 1) (the cache is built
    separately); outside decode a VLM's image_embeds (B, n_image_tokens,
    D) and an audio model's frames (B, encoder_len, D), in the compute
    dtype. `shape` has global_batch, seq_len and kind; for_train, when
    given, overrides the kind (train, or the shape's own)."""
    b, s = shape.global_batch, shape.seq_len
    kind = shape.kind if for_train is None else ("train" if for_train else shape.kind)
    seq = {"train": s + 1, "prefill": s, "decode": 1}[kind]
    specs = {"tokens": ((b, seq), torch.int32)}
    dt = getattr(torch, cfg.compute_dtype)
    if cfg.family == "vlm" and kind != "decode":
        specs["image_embeds"] = ((b, cfg.n_image_tokens, cfg.d_model), dt)
    if cfg.family == "audio" and kind != "decode":
        specs["frames"] = ((b, cfg.encoder_len, cfg.d_model), dt)
    return specs


# The logical axis names of each leaf, by its last name (a norm's scale and
# bias, q/k norms, the polynomial LayerNorms and the SSM's scalars are
# replicated); the FFN's and the attention's names depend on the owner.
_LEAF_AXES = {
    "table": ("vocab", "embed"),
    "lm_head": ("embed", "vocab"),
    "wq": ("embed", "q_heads", "head_dim"),
    "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"),
    "router": ("embed", "experts"),
    # learned sketch projections (core/sketches), and a random one's g
    "w1": (None, "sketch_hidden"), "w3": (None, "sketch_hidden"),
    "b1": ("sketch_hidden",), "b3": ("sketch_hidden",),
    "w2": ("sketch_hidden", None), "w4": ("sketch_hidden", None),
    "g": (None, "sketch"),
    # RG-LRU
    "w_gate": ("embed", "rnn"), "w_in": ("embed", "rnn"),
    "w_a": ("rnn", "rnn2"), "w_x": ("rnn", "rnn2"), "w_out": ("rnn", "embed"),
    "b_a": ("rnn",), "b_x": ("rnn",), "lambda": ("rnn",),
    # RG-LRU and SSD convolutions; SSD projections
    "conv_w": (None, "rnn"), "conv_b": ("rnn",),
    "in_proj": ("embed", "rnn"), "out_proj": ("rnn", "embed"),
}
_FFN_AXES = {   # by leaf and ndim: the GLU FFN (2) or the MoE experts (3)
    ("wi", 2): ("embed", "mlp"), ("wg", 2): ("embed", "mlp"), ("wo", 2): ("mlp", "embed"),
    ("wi", 3): ("experts", "embed", "mlp"), ("wg", 3): ("experts", "embed", "mlp"),
    ("wo", 3): ("experts", "mlp", "embed"),
}


def leaf_axes(name: str, shape: tuple) -> tuple:
    """The reference's logical axis names of the port's parameter `name`
    of `shape`, without the reference's leading "layers" entry (the port
    keeps one module a layer)."""
    parts = name.split(".")
    leaf = parts[-1]
    if len(parts) >= 2 and parts[-2] == "ffn" and (leaf, len(shape)) in _FFN_AXES:
        return _FFN_AXES[(leaf, len(shape))]
    if leaf == "wo":
        return ("q_heads", "head_dim", "embed")
    if leaf in _LEAF_AXES:
        return _LEAF_AXES[leaf]
    if len(shape) == 1:
        return (None,)
    raise KeyError(f"no logical axes for parameter {name!r} of shape {tuple(shape)}")


def param_axes(lm) -> dict[str, tuple]:
    """{parameter name: logical axis names} of an LM or a Whisper, in
    named_parameters' order. Through ``bridge.jax_path`` each equals the
    reference's axes leaf, less its leading "layers" for a stacked leaf."""
    return {n: leaf_axes(n, tuple(p.shape)) for n, p in lm.named_parameters()}
