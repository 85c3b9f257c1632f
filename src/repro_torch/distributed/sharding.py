"""Logical-axis sharding rules -> partition specs, and the FSDP storage
that the port's ``--mesh`` training keeps by them.

The port of the JAX package's ``distributed/sharding.py``. Every
parameter carries a tuple of logical axis names, one per dim
(``models.model_zoo.param_axes``). A rules table maps each logical name
to an ordered list of candidate mesh axes; assignment is greedy per
tensor: the first candidate that (a) exists in the mesh, (b) is not
already used by another dim of the same tensor, and (c) divides the
dimension size, wins. The default rules are the reference's own copy:
FSDP over "data" (the embedding dim), tensor parallelism over "model"
(heads, mlp, vocab, experts, rnn), data parallelism over ("pod", "data").

A spec is a tuple with one entry per dim (trailing replicated dims
dropped, as ``PartitionSpec`` drops them): None (replicated), a mesh axis
name, or a tuple of axis names (the batch dim over several axes). It
equals the reference's ``PartitionSpec`` entry for entry. A mesh is a
``torch.distributed.device_mesh.DeviceMesh``, anything with
``axis_names`` and ``devices.shape`` (the reference's duck type), or a
plain ``{axis: size}``.

The port runs one process a rank. What the specs place is storage:
``shard`` keeps a rank's block of a tensor, ``gather`` rebuilds the
whole tensor (or its block of the axes not named) from every rank's
block, and ``reduce_grad`` turns each rank's gradient of its own rows
into its block of the mean gradient. The compute splits over "model"
(``distributed/tensor_parallel.py``): under ``activation_sharding`` each
"model" rank computes its own heads, mlp columns and (in training) vocab
rows and experts, and ``shard_act`` gathers the reference's gather points whole when
the active rules map them to () (serving), or leaves them split for the
Megatron partial sum (training). The collectives are plain
``torch.distributed`` calls on each mesh axis's group (gloo moves CUDA
tensors through the host, so ranks that share one card can run them).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro_torch.distributed import tensor_parallel as tp

DEFAULT_RULES: dict[str | None, tuple[str, ...]] = {
    None: (),
    "batch": ("pod", "data"),       # special-cased: multi-axis
    "seq": (),                      # flip to ("data",) for sequence parallel
    "vocab": ("model",),
    "embed": ("data",),
    "q_heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": ("model",),
    "mlp": ("model",),
    # pre-contraction activation gather points: the reference's training
    # keeps them sharded on "model", its serving maps them to ()
    "act_heads": ("model",),
    "act_mlp": ("model",),
    "experts": ("model",),
    "rnn": ("model",),
    "rnn2": (),
    "sketch": (),
    "sketch_hidden": (),
    "layers": (),
    "state": (),
}

Spec = tuple


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh, of a mesh with axis_names and
    devices.shape, or of a plain {axis: size}."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def spec_for(names: tuple, shape: tuple, mesh, rules: dict | None = None) -> Spec:
    """The partition spec of a tensor of `shape` whose dims carry the
    logical `names`, by the greedy rule (module docstring)."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_axis_sizes(mesh)
    used: set[str] = set()
    out: list[Any] = []
    for name, dim in zip(names, shape):
        cands = rules.get(name, ())
        if name == "batch":
            axes = [a for a in cands if a in sizes and a not in used]
            group: list[str] = []
            prod = 1
            for a in axes:
                if dim % (prod * sizes[a]) == 0:
                    group.append(a)
                    prod *= sizes[a]
            used.update(group)
            out.append(tuple(group) if len(group) > 1 else (group[0] if group else None))
            continue
        pick = None
        for a in cands:
            if a in sizes and a not in used and dim % sizes[a] == 0:
                pick = a
                break
        if pick:
            used.add(pick)
        out.append(pick)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def shardings_for(axes: dict[str, tuple], shapes: dict, mesh,
                  rules=None) -> dict[str, Spec]:
    """{name: spec} for a flat tree of parameters: `axes` maps each name
    to its logical names, `shapes` to its shape (or the tensor)."""
    if set(axes) != set(shapes):
        raise KeyError(f"axes and shapes differ: {sorted(set(axes) ^ set(shapes))}")
    return {n: spec_for(axes[n], tuple(getattr(s, "shape", s)), mesh, rules)
            for n, s in shapes.items()}


def batch_spec(mesh, batch_size: int, ndim: int = 2, rules=None) -> Spec:
    """The spec of a batch of `batch_size` rows: its leading dim over the
    rules' batch axes that divide it, the rest replicated."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_axis_sizes(mesh)
    group: list[str] = []
    prod = 1
    for a in rules["batch"]:
        if a in sizes and batch_size % (prod * sizes[a]) == 0:
            group.append(a)
            prod *= sizes[a]
    lead = tuple(group) if len(group) > 1 else (group[0] if group else None)
    return (lead, *([None] * (ndim - 1)))


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major to minor."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh) -> list:
    """The DTensor placements of `spec` on `mesh`, one per mesh dim:
    Shard(d) where the axis shards tensor dim d, else Replicate()."""
    where = {a: d for d, entry in enumerate(spec) for a in spec_axes(entry)}
    return [Shard(where[a]) if a in where else Replicate()
            for a in mesh_axis_sizes(mesh)]


# ---------------------------------------------------------------------------
# FSDP storage over a DeviceMesh: a rank keeps the block of each tensor
# that its spec names, major axis first where one dim carries several
# ---------------------------------------------------------------------------

def _axis(mesh, a):
    return mesh.size(mesh.mesh_dim_names.index(a)), mesh.get_local_rank(a)


def shard(full: torch.Tensor, spec: Spec, mesh, axes=None) -> torch.Tensor:
    """This rank's block of `full`, which holds the same values on every
    rank, over the spec's axes (only `axes` when given); a copy, so the
    whole tensor's storage can be freed."""
    x = full
    for d, entry in enumerate(spec):
        for a in spec_axes(entry):
            if axes is not None and a not in axes:
                continue
            n, r = _axis(mesh, a)
            step = x.shape[d] // n
            x = x.narrow(d, r * step, step)
    return x.clone(memory_format=torch.contiguous_format)


def gather(local: torch.Tensor, spec: Spec, mesh, axes=None) -> torch.Tensor:
    """The tensor from every rank's block: whole, or gathered over `axes`
    only (the others stay this rank's block)."""
    x = local
    for d, entry in reversed(list(enumerate(spec))):
        for a in reversed(spec_axes(entry)):          # minor axis first
            if axes is not None and a not in axes:
                continue
            n, _ = _axis(mesh, a)
            if n == 1:
                continue
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x.contiguous(), group=mesh.get_group(a))
            x = torch.cat(parts, dim=d)
    return x


def reduce_grad(full: torch.Tensor, spec: Spec, mesh, dp_axes: tuple[str, ...],
                local_axes: tuple[str, ...] = ()) -> torch.Tensor:
    """This rank's block of the mean over the data-parallel ranks of each
    rank's gradient `full` of its own rows: summed over the data axes
    (the same values over any other: its ranks computed the same rows),
    divided by their number, and cut to the spec's block. `full` is
    already this rank's block over `local_axes` (the "model" axis whose
    compute it split)."""
    g = full.contiguous()
    ranks = 1
    for a in dp_axes:
        n, _ = _axis(mesh, a)
        if n > 1:
            g = g.clone() if g is full else g
            dist.all_reduce(g, group=mesh.get_group(a))
        ranks *= n
    block = shard(g, spec, mesh, axes=[a for a in mesh.mesh_dim_names
                                        if a not in local_axes])
    return block / ranks if ranks > 1 else block


def global_sumsq(blocks: dict[str, torch.Tensor], specs: dict[str, Spec], mesh
                 ) -> torch.Tensor:
    """The sum of squares (f32) of the whole tensors whose blocks this rank
    holds: each block's sum over the ranks that hold distinct blocks of it
    (a block held by several ranks counted once)."""
    world = math.prod(mesh.size(i) for i in range(len(mesh.mesh_dim_names)))
    total = torch.zeros((), dtype=torch.float32,
                        device=next(iter(blocks.values())).device)
    for n, g in blocks.items():
        held = math.prod(_axis(mesh, a)[0] for e in specs[n] for a in spec_axes(e))
        total = total + torch.sum(torch.square(g.to(torch.float32))) / (world // held)
    if world > 1:
        dist.all_reduce(total)
    return total


# ---------------------------------------------------------------------------
# Activation sharding constraints. The reference constrains activations at
# block boundaries (XLA's propagation gives up inside layer scans); in the
# port the context makes the mesh, the rules and the "model" group known to
# the model code (distributed/tensor_parallel.py), and shard_act gathers a
# gather point whole where the rules map it to ().
# ---------------------------------------------------------------------------

# the reference's gather points: a dim that holds this rank's block of the
# heads (mlp columns) right before the contraction over them
GATHER_POINTS = ("act_heads", "act_mlp")


@contextlib.contextmanager
def activation_sharding(mesh, rules: dict | None = None, *, vocab_head: bool = False):
    """Make `mesh` and `rules` (default DEFAULT_RULES) active for the model
    code on this thread; `vocab_head`: an untied lm_head holds this rank's
    vocab columns (a serving placement's), so the logits are gathered."""
    with tp.activate(mesh, rules or DEFAULT_RULES, vocab_head=vocab_head):
        yield


def shard_act(x, *logical_names):
    """The reference's activation constraint. The port's compute holds
    this rank's block of the heads and mlp columns already, so the only
    move is at a gather point whose logical name the active rules map to
    () (serving): its dim is gathered whole over "model". Elsewhere (no
    context, one "model" rank, training's partial sums, other names) it is
    x itself. "experts" is no gather point: where the rules split the
    experts (training), models/moe.py fills and runs each rank's own
    experts and gathers their outputs whole itself
    (tensor_parallel.gather_model), so the reference's constraints on the
    expert buffer ("experts", "batch") are x here."""
    ctx = tp.active()
    if ctx is None or ctx.size == 1:
        return x
    for dim, name in enumerate(logical_names):
        if name in GATHER_POINTS and not tp.keeps(name):
            x = tp.gather(x, dim)
    return x
