"""Parameter bridge between the JAX package's tree and the port's modules.

The JAX LM keeps its layers stacked: the leaf at tree path
``groups/block0/mixer/wq`` has shape (n_layers, d, Hq, h). Flattened by
tree path (the ``/``-joined format of the reference's ``tree_paths``),
those leaves map onto the port's parameters as

    embed/table                 -> embed.table
    final_norm/<p>              -> final_norm.<p>
    groups/block0/<path>[i]     -> layers.<i>.<path with . for />

Arrays move as they are: the port keeps the JAX layouts.

A training state moves as the flat arrays of the reference's checkpoint
(``checkpoint/manager.py``'s keys): ``.params/<path>``, ``.opt/.m/<path>``,
``.opt/.v/<path>``, ``.opt/.count`` and ``.step``, layer-stacked, so a
checkpoint written by either package restores in the other.
"""
from __future__ import annotations

import numpy as np
import torch

LAYER_GROUP = "groups/block0/"


def params_from_jax(flat: dict[str, np.ndarray], cfg) -> dict[str, torch.Tensor]:
    """A state dict for the port's LM from flattened JAX params. Raises on
    a leaf it cannot place or a layer count that does not match cfg."""
    sd = {}
    for path, arr in flat.items():
        # host numpy; the analyzer reaches this only through the name `restore`
        # jaxlint: disable=host-sync-in-jit-path -- no jit in the port
        arr = np.asarray(arr)
        if path.startswith(LAYER_GROUP):
            if arr.shape[0] != cfg.n_layers:
                raise ValueError(f"{path}: {arr.shape[0]} stacked layers, "
                                 f"config has {cfg.n_layers}")
            sub = path[len(LAYER_GROUP):].replace("/", ".")
            for i in range(cfg.n_layers):
                sd[f"layers.{i}.{sub}"] = torch.from_numpy(arr[i].copy())
        elif path.startswith(("embed/", "final_norm/")):
            sd[path.replace("/", ".")] = torch.from_numpy(arr.copy())
        else:
            raise KeyError(f"no place in the port for JAX leaf {path!r}")
    return sd


def jax_path(name: str) -> str:
    """The JAX tree path of the port's parameter `name` (layer index
    dropped: the reference stacks the layers)."""
    if name.startswith("layers."):
        return LAYER_GROUP + name.split(".", 2)[2].replace(".", "/")
    return name.replace(".", "/")


def params_to_jax(lm) -> dict[str, np.ndarray]:
    """The inverse: the port's parameters as flattened, layer-stacked JAX
    leaves (path -> array). On the meta device, arrays of the right shape
    and dtype with no data (np.empty)."""
    return named_to_jax(dict(lm.named_parameters()))


def named_to_jax(named: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Tensors keyed by the port's parameter names (parameters, or
    optimizer moments) as layer-stacked JAX leaves."""
    per_layer: dict[str, list] = {}
    flat = {}

    def host(t):
        if t.device.type == "meta":
            return np.empty(tuple(t.shape), dtype=np.float32)
        return t.detach().cpu().numpy()

    for name, p in named.items():   # layers in order, as named_parameters gives them
        path = jax_path(name)
        if path.startswith(LAYER_GROUP):
            per_layer.setdefault(path, []).append(host(p))
        else:
            flat[path] = host(p)
    for path, arrs in per_layer.items():
        flat[path] = np.stack(arrs)
    return flat


def train_state_to_jax(state) -> dict[str, np.ndarray]:
    """The port's TrainState as the reference checkpoint's flat arrays
    (keys as the module docstring lists them; count and step int32)."""
    flat = {}
    for prefix, named in ((".params/", dict(state.lm.named_parameters())),
                          (".opt/.m/", state.opt.m), (".opt/.v/", state.opt.v)):
        flat.update({prefix + k: v for k, v in named_to_jax(named).items()})
    flat[".opt/.count"] = np.asarray(int(state.opt.count), np.int32)
    flat[".step"] = np.asarray(state.step, np.int32)
    return flat


def train_state_from_jax(flat: dict[str, np.ndarray], lm):
    """Load the flat arrays of a reference TrainState (train_state_to_jax's
    keys) into `lm`'s parameters, and return the port's TrainState around
    it (moments on lm's device). Raises on a missing or extra key."""
    from repro_torch.optim.adamw import AdamWState   # imports this module
    from repro_torch.train.step import TrainState

    cfg, dev = lm.cfg, lm.embed.table.device

    def part(prefix):
        sub = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
        return {n: t.to(dev) for n, t in params_from_jax(sub, cfg).items()}

    known = {".opt/.count", ".step"}
    extra = [k for k in flat if k not in known
             and not k.startswith((".params/", ".opt/.m/", ".opt/.v/"))]
    if extra or not known <= set(flat):
        raise KeyError(f"not a training state: extra {extra}, missing "
                       f"{sorted(known - set(flat))}")
    with torch.no_grad():
        lm.load_state_dict(part(".params/"), strict=True)
    m, v = part(".opt/.m/"), part(".opt/.v/")
    names = {n for n, _ in lm.named_parameters()}
    if set(m) != names or set(v) != names:
        raise KeyError("optimizer moments do not match the parameters")
    count = torch.tensor(int(flat[".opt/.count"]), dtype=torch.int32, device=dev)
    return TrainState(lm, AdamWState(m, v, count), int(flat[".step"]))
