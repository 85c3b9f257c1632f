"""Parameter bridge between the JAX package's tree and the port's modules.

The JAX LM keeps its layers stacked: the leaf at tree path
``groups/block0/mixer/wq`` has shape (n_layers, d, Hq, h). Flattened by
tree path (the ``/``-joined format of the reference's ``tree_paths``),
those leaves map onto the port's parameters as

    embed/table                 -> embed.table
    final_norm/<p>              -> final_norm.<p>
    groups/block0/<path>[i]     -> layers.<i>.<path with . for />

Arrays move as they are: the port keeps the JAX layouts.
"""
from __future__ import annotations

import numpy as np
import torch

_GROUP = "groups/block0/"


def params_from_jax(flat: dict[str, np.ndarray], cfg) -> dict[str, torch.Tensor]:
    """A state dict for the port's LM from flattened JAX params. Raises on
    a leaf it cannot place or a layer count that does not match cfg."""
    sd = {}
    for path, arr in flat.items():
        arr = np.asarray(arr)
        if path.startswith(_GROUP):
            if arr.shape[0] != cfg.n_layers:
                raise ValueError(f"{path}: {arr.shape[0]} stacked layers, "
                                 f"config has {cfg.n_layers}")
            sub = path[len(_GROUP):].replace("/", ".")
            for i in range(cfg.n_layers):
                sd[f"layers.{i}.{sub}"] = torch.from_numpy(arr[i].copy())
        elif path.startswith(("embed/", "final_norm/")):
            sd[path.replace("/", ".")] = torch.from_numpy(arr.copy())
        else:
            raise KeyError(f"no place in the port for JAX leaf {path!r}")
    return sd


def params_to_jax(lm) -> dict[str, np.ndarray]:
    """The inverse: the port's parameters as flattened, layer-stacked JAX
    leaves (path -> array). On the meta device, arrays of the right shape
    and dtype with no data (np.empty)."""
    per_layer: dict[str, list] = {}
    flat = {}

    def host(t):
        if t.device.type == "meta":
            return np.empty(tuple(t.shape), dtype=np.float32)
        return t.detach().cpu().numpy()

    for name, p in lm.named_parameters():
        if name.startswith("layers."):
            _, _, sub = name.split(".", 2)
            per_layer.setdefault(sub, []).append(host(p))
        else:
            flat[name.replace(".", "/")] = host(p)
    for sub, arrs in per_layer.items():
        flat[_GROUP + sub.replace(".", "/")] = np.stack(arrs)
    return flat
