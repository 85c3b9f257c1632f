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

The port computes replicated: every rank runs the whole model on its
rows of the batch. What the specs place is storage, as DTensor
placements (``placements``): ``shard`` keeps a rank's block of a tensor,
``gather`` rebuilds the whole tensor from every rank's block, and
``reduce_grad`` turns each rank's gradient of its own rows into its block
of the mean gradient. Splitting the compute itself over "model" (the
reference's Megatron contraction) is not ported.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

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
# FSDP storage over a DeviceMesh, through DTensor: a rank keeps the local
# block of a DTensor placed by its spec
# ---------------------------------------------------------------------------

def shard(full: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of `full`, which holds the same values on every
    rank (a copy: the whole tensor's storage can be freed)."""
    local = distribute_tensor(full, mesh, placements(spec, mesh),
                              src_data_rank=None).to_local()
    return local.clone(memory_format=torch.contiguous_format)


def gather(local: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block."""
    return DTensor.from_local(local, mesh, placements(spec, mesh)).full_tensor()


def reduce_grad(full: torch.Tensor, spec: Spec, mesh, dp_axes: tuple[str, ...]
                ) -> torch.Tensor:
    """This rank's block of the mean over the data-parallel ranks of each
    rank's whole gradient `full` (of its own rows): partial sums over the
    data axes, the same values over any other (its ranks computed the same
    rows), redistributed to the spec's placements (a reduce-scatter or an
    all-reduce over a data axis, a slice over another) and divided by the
    number of data ranks."""
    src = [Partial() if a in dp_axes else Replicate() for a in mesh.mesh_dim_names]
    block = DTensor.from_local(full, mesh, src).redistribute(
        mesh, placements(spec, mesh)).to_local()
    ranks = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in dp_axes)
    return block / ranks if ranks > 1 else block.contiguous()


def global_sumsq(blocks: dict[str, torch.Tensor], specs: dict[str, Spec], mesh
                 ) -> torch.Tensor:
    """The sum of squares (f32) of the whole tensors whose blocks this rank
    holds: each block's sum, summed over the ranks that shard it."""
    return sum(torch.sum(torch.square(DTensor.from_local(
        g.to(torch.float32), mesh, placements(specs[n], mesh)))).full_tensor()
        for n, g in blocks.items())


# ---------------------------------------------------------------------------
# Activation sharding constraints. The reference constrains activations at
# block boundaries (XLA's propagation gives up inside layer scans); the
# port computes replicated, so a constraint has nothing to place: shard_act
# returns its input, inside the context or not.
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def activation_sharding(mesh, rules: dict | None = None):
    yield


def shard_act(x, *logical_names):
    """The reference's activation constraint: x itself (compute is
    replicated in the port)."""
    return x
