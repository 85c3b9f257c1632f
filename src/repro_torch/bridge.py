"""Parameter bridge between the JAX package's tree and the port's modules.

The JAX LM stacks its layers in pattern groups: a config's effective
pattern of (mixer, FFN) pairs (e.g. recurrentgemma's (rglru, rglru,
local_attn), or llama4-maverick's GLU layer then MoE layer; of length g)
repeats n_layers // g times, and the leaf at ``groups/block{b}/<path>`` holds
block b of every group, stacked on a leading group axis; the n_layers % g
layers left over form an unstacked tail, ``tail/block{b}/<path>``. The
port keeps one module per layer, so its layer i is group i // g, block
i % g, and the tail follows the groups. Flattened by tree path (the
``/``-joined format of the reference's ``tree_paths``):

    embed/table                   -> embed.table
    final_norm/<p>                -> final_norm.<p>
    groups/block{b}/<path>[j]     -> layers.<j * g + b>.<path with . for />
    tail/block{b}/<path>          -> layers.<n_groups * g + b>.<path>

A dense model (pattern ("attn",)) has g = 1 and no tail: every layer is
``groups/block0`` stacked over n_layers. An MoE layer's FFN leaves are
``ffn/{router,wi,wg,wo}``, stacked over the groups like any other.
Untied embeddings (and only they) add the top-level ``lm_head`` ->
``lm_head``.

The encoder-decoder (``cfg.family == "audio"``, ``models/whisper.py``)
stacks its encoder and decoder layers each on one leading axis:

    embed/table                   -> embed.table
    enc/<path>[j]                 -> enc.<j>.<path with . for />
    dec/<path>[j]                 -> dec.<j>.<path>
    enc_norm/<p>, dec_norm/<p>    -> enc_norm.<p>, dec_norm.<p>

(``enc_norm/`` is not under ``enc/``.) Every mapping takes the config,
which fixes g and the tail, or the family. Arrays move as they are: the
port keeps the JAX layouts.

A training state moves as the flat arrays of the reference's checkpoint
(``checkpoint/manager.py``'s keys): ``.params/<path>``, ``.opt/.m/<path>``,
``.opt/.v/<path>``, ``.opt/.count`` and ``.step``, group-stacked, so a
checkpoint written by either package restores in the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import effective_pattern

GROUPS, TAIL = "groups/", "tail/"
ENC, DEC = "enc/", "dec/"          # the encoder-decoder's two stacks


def group_shape(cfg) -> tuple[int, int, int]:
    """(pattern length g, stacked groups, tail layers) of a config: g is
    the effective pattern's, lcm(len(block_pattern), moe_period)."""
    g = len(effective_pattern(cfg))
    n_groups, rem = divmod(cfg.n_layers, g)
    return g, n_groups, rem


def layer_prefix(i: int, cfg) -> str:
    """The JAX path prefix of the port's layer i: its block in the stacked
    groups, or in the unstacked tail."""
    g, n_groups, _ = group_shape(cfg)
    if i < n_groups * g:
        return f"{GROUPS}block{i % g}/"
    return f"{TAIL}block{i - n_groups * g}/"


def stacks(cfg) -> dict[str, int]:
    """The config's stacked path prefixes and their layer counts: the
    LM's groups, or the encoder-decoder's encoder and decoder."""
    if cfg.family == "audio":
        return {ENC: cfg.encoder_layers, DEC: cfg.n_layers}
    return {GROUPS: group_shape(cfg)[1]}


def is_stacked(path: str, cfg) -> bool:
    """Whether the reference stacks the leaf at `path` over layers."""
    return path.startswith(tuple(stacks(cfg)))


def params_from_jax(flat: dict[str, np.ndarray], cfg) -> dict[str, torch.Tensor]:
    """A state dict for the port's LM (or Whisper) from flattened JAX
    params. Raises on a leaf it cannot place or a layer count that does
    not match cfg."""
    if cfg.family == "audio":
        return _whisper_params_from_jax(flat, cfg)
    g, n_groups, rem = group_shape(cfg)
    sd = {}
    for path, arr in flat.items():
        # host numpy; the analyzer reaches this only through the name `restore`
        # jaxlint: disable=host-sync-in-jit-path -- no jit in the port
        arr = np.asarray(arr)
        if path.startswith((GROUPS, TAIL)):
            top, block, sub = path.split("/", 2)
            b = int(block[len("block"):])
            sub = sub.replace("/", ".")
            if top + "/" == GROUPS:
                if b >= g or arr.shape[0] != n_groups:
                    raise ValueError(f"{path}: {arr.shape[0]} stacked layers, "
                                     f"config has {n_groups} groups of {g}")
                for j in range(n_groups):
                    sd[f"layers.{j * g + b}.{sub}"] = torch.from_numpy(arr[j].copy())
            else:
                if b >= rem:
                    raise KeyError(f"no tail block {b} in the port for {path!r}")
                sd[f"layers.{n_groups * g + b}.{sub}"] = torch.from_numpy(arr.copy())
        elif (path.startswith(("embed/", "final_norm/"))
              or path == "lm_head" and not cfg.tie_embeddings):
            sd[path.replace("/", ".")] = torch.from_numpy(arr.copy())
        else:
            raise KeyError(f"no place in the port for JAX leaf {path!r}")
    return sd


def _whisper_params_from_jax(flat, cfg):
    counts, sd = stacks(cfg), {}
    for path, arr in flat.items():
        # jaxlint: disable=host-sync-in-jit-path -- no jit in the port
        arr = np.asarray(arr)
        top = path.split("/", 1)[0] + "/"
        if top in counts:
            if arr.shape[0] != counts[top]:
                raise ValueError(f"{path}: {arr.shape[0]} stacked layers, config "
                                 f"has {counts[top]}")
            sub = path[len(top):].replace("/", ".")
            for j in range(counts[top]):
                sd[f"{top[:-1]}.{j}.{sub}"] = torch.from_numpy(arr[j].copy())
        elif top in ("embed/", "enc_norm/", "dec_norm/"):
            sd[path.replace("/", ".")] = torch.from_numpy(arr.copy())
        else:
            raise KeyError(f"no place in the port for JAX leaf {path!r}")
    return sd


def jax_path(name: str, cfg) -> str:
    """The JAX tree path of the port's parameter `name` (the layer index
    dropped: the reference stacks the groups, or the encoder's and the
    decoder's layers)."""
    if cfg.family == "audio" and name.startswith(("enc.", "dec.")):
        top, _, sub = name.split(".", 2)
        return f"{top}/" + sub.replace(".", "/")
    if name.startswith("layers."):
        _, i, sub = name.split(".", 2)
        return layer_prefix(int(i), cfg) + sub.replace(".", "/")
    return name.replace(".", "/")


def params_to_jax(lm) -> dict[str, np.ndarray]:
    """The inverse: the port's parameters as flattened, group-stacked JAX
    leaves (path -> array). On the meta device, arrays of the right shape
    and dtype with no data (np.empty)."""
    return named_to_jax(dict(lm.named_parameters()), lm.cfg)


def named_to_jax(named: dict[str, torch.Tensor], cfg) -> dict[str, np.ndarray]:
    """Tensors keyed by the port's parameter names (parameters, or
    optimizer moments) as stacked JAX leaves."""
    stacked: dict[str, list] = {}
    flat = {}

    def host(t):
        if t.device.type == "meta":
            return np.empty(tuple(t.shape), dtype=np.float32)
        return t.detach().cpu().numpy()

    for name, p in named.items():   # layers in order, as named_parameters gives them
        path = jax_path(name, cfg)
        if is_stacked(path, cfg):
            stacked.setdefault(path, []).append(host(p))
        else:
            flat[path] = host(p)
    for path, arrs in stacked.items():
        flat[path] = np.stack(arrs)
    return flat


def train_state_to_jax(state) -> dict[str, np.ndarray]:
    """The port's TrainState as the reference checkpoint's flat arrays
    (keys as the module docstring lists them; count and step int32)."""
    cfg = state.lm.cfg
    flat = {}
    for prefix, named in ((".params/", dict(state.lm.named_parameters())),
                          (".opt/.m/", state.opt.m), (".opt/.v/", state.opt.v)):
        flat.update({prefix + k: v for k, v in named_to_jax(named, cfg).items()})
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
