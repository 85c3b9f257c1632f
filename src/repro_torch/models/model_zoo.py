"""Model facade of the port: ``build_model(cfg, device=)``.

Port of the JAX package's ``models/model_zoo.py`` for the dense
polysketch family: the LM module (which holds the parameters) and its
``DecodeState``.
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
                params: dict[str, torch.Tensor] | None = None) -> Model:
    """Build the LM on `device` (default cuda; raises with no card).

    Weights are drawn from a CPU torch.Generator seeded with `seed`, with
    the reference's init distributions, so a seed gives the same weights
    on every device; on the meta device nothing is drawn. `params` (a
    state dict, e.g. from bridge.params_from_jax) replaces them.
    """
    dev = (torch.device("meta") if device == "meta"
           else resolve_device(device))
    gen = torch.Generator().manual_seed(seed)
    lm = LM(cfg, generator=gen, device=dev)
    if params is not None:
        lm.load_state_dict(params, strict=True)
    lm.eval()
    lm.requires_grad_(False)
    return Model(cfg, lm, DecodeState(lm))
