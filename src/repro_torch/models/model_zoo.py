"""Model facade of the port: ``build_model(cfg, device=)``.

Port of the JAX package's ``models/model_zoo.py`` for the decoder-only
LMs (dense, recurrent and mixture-of-experts): the LM module (which holds the parameters) and its
``DecodeState``. A served model is frozen and in eval mode; with
``trainable=True`` every parameter takes a gradient except a random
sketch's projection ``g``, which the reference keeps frozen with
``stop_gradient``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.state import DecodeState
from repro_torch.models.transformer import LM
from repro_torch.utils import resolve_device


@dataclass
class Model:
    cfg: object
    lm: LM
    state: DecodeState

    @property
    def device(self) -> torch.device:
        return self.lm.embed.table.device


def build_model(cfg, *, device=None, seed: int = 0,
                params: dict[str, torch.Tensor] | None = None,
                trainable: bool = False, draw_on_device: bool = False) -> Model:
    """Build the LM on `device` (default cuda; raises with no card).

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
    lm = LM(cfg, generator=gen, device=dev)
    if params is not None:
        lm.load_state_dict(params, strict=True)
    lm.train(trainable)
    for name, p in lm.named_parameters():
        p.requires_grad_(trainable and not _frozen(name))
    return Model(cfg, lm, DecodeState(lm))


def _frozen(name: str) -> bool:
    """A random sketch projection (RandomProjection.g): frozen in training."""
    return name.endswith(".g")
