"""ServePlan: where the serving stack's tensors live.

The port of the JAX package's ``serve/plan.py``. One object answers the
engine's placement questions: the device it serves on, how parameters
would split for tensor parallelism on the "model" axis, and how
slot-stacked caches and per-slot sampling state would spread over the
"data" axis. The specs come from the port's
``distributed/sharding.spec_for`` under the reference's two rule tables,
so each equals the reference's ``PartitionSpec`` entry for entry.

A plan over one device needs no process group
(``ServePlan.single_device(device)``; ``serve/replicas.replica_plans``
gives each replica one, on its own card when there are enough): every
spec is then replicated in effect. A plan over a DeviceMesh of D x M
running ranks (``ServePlan.build(D, M)``, one process a rank, every rank
running the same engine loop) splits the slots over "data" (data rank d
holds the d-th share of the slot stack: ``slot_range``) and the heads
over "model": ``place`` keeps this rank's blocks of the weights that
PARAM_RULES splits on heads and mlp (wq/wk/wv, the GLU's wi/wg: the
blocks the compute reads), and with ``shard_model`` of an untied lm_head
on vocab too; the rest whole. Its caches hold its kv heads
(``state_shard_axes``). Under ``activation_context`` (SERVING_RULES) the
gather points and an lm_head's vocab are gathered whole before their
contraction or reduction. Snapshots are gathered whole over "model" before a prefix
cache stores them and restored to this rank's heads
(``gather_snapshot``, ``local_snapshot``), so they do not depend on the
mesh.

Bit-parity contract (the reference's): SERVING_RULES names only the
batch/slot dim ("data") and the head dims ("model"), and PARAM_RULES only
the output dims of dense weights whose first logical axis is "embed"
(wq/wk/wv on heads, the GLU's wi/wg on mlp, lm_head on vocab), so no
split would change the operand order of a floating-point reduction.
"""
from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.core.state import DecodeState, snapshot_map_heads, state_shard_axes
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import activation_sharding, mesh_axis_sizes, spec_for
from repro_torch.utils import resolve_device

# Logical name -> mesh-axis candidates for serving-time activations and
# decode state; a name absent here is replicated (spec_for's rules.get).
SERVING_RULES: dict[str | None, tuple[str, ...]] = {
    None: (),
    "batch": ("data",),
    "q_heads": ("model",),
    "kv_heads": ("model",),
}

# Logical name -> mesh-axis candidates for parameter tensors (applied only
# to weights whose first logical axis is "embed"; see param_specs).
PARAM_RULES: dict[str | None, tuple[str, ...]] = {
    None: (),
    "q_heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
}

SERVING_AXES = ("data", "model")
ONE_DEVICE = {"data": 1, "model": 1}


def default_device(device) -> torch.device:
    """`device`, or the current card (utils.resolve_device: raises without
    one; never the CPU unasked)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class ServePlan:
    """A ("data", "model") mesh, the device this process serves on, and
    whether parameters split over "model". `mesh` is a DeviceMesh, anything
    with `axis_names` and `devices.shape`, or a plain {axis: size}."""
    mesh: object
    device: torch.device
    shard_model: bool = False

    # -- construction -----------------------------------------------------

    @classmethod
    def from_mesh(cls, mesh, *, shard_model: bool = False, device=None):
        names = tuple(mesh_axis_sizes(mesh))
        if names != SERVING_AXES:
            raise ValueError(
                f"ServePlan needs a {SERVING_AXES} mesh, got axes {names}; "
                "build one with launch.mesh.make_serving_mesh")
        return cls(mesh=mesh, device=default_device(device),
                   shard_model=shard_model)

    @classmethod
    def build(cls, data: int = 1, model: int = 1, *,
              shard_model: bool = False, device=None):
        """A 1x1 plan needs nothing; a larger one a DeviceMesh over the
        running ranks (launch.mesh.make_serving_mesh)."""
        if data * model == 1:
            return cls.single_device(device)
        from repro_torch.launch.mesh import make_serving_mesh
        device = default_device(device)
        return cls.from_mesh(make_serving_mesh(data * model, model, device.type),
                             shard_model=shard_model, device=device)

    @classmethod
    def single_device(cls, device=None):
        """The 1x1 plan on `device` (default: the current card; raises
        without one); no process group needed."""
        return cls(mesh=dict(ONE_DEVICE), device=default_device(device))

    # -- introspection ----------------------------------------------------

    @property
    def axis_sizes(self) -> dict[str, int]:
        return mesh_axis_sizes(self.mesh)

    def describe(self) -> str:
        s = self.axis_sizes
        return f"{s['data']}x{s['model']}"

    @property
    def n_devices(self) -> int:
        s = self.axis_sizes
        return s["data"] * s["model"]

    # -- the mesh as this rank sees it -----------------------------------

    def _axis(self, name) -> tuple[int, int]:
        """(size, this rank's index) of a mesh axis."""
        names = getattr(self.mesh, "mesh_dim_names", None)
        size = self.axis_sizes[name]
        if names is None or size == 1:
            if size > 1:
                raise ValueError(
                    f"a {self.describe()} plan needs a DeviceMesh over its running ranks "
                    "(ServePlan.build, launch.mesh.make_serving_mesh), not a plain "
                    "{axis: size}")
            return 1, 0
        return size, self.mesh.get_local_rank(name)

    @property
    def data(self) -> tuple[int, int]:
        """(size, index) of this rank on the "data" axis."""
        return self._axis("data")

    @property
    def model(self) -> tuple[int, int]:
        """(size, index) of this rank on the "model" axis."""
        return self._axis("model")

    def slot_range(self, slots: int) -> tuple[int, int]:
        """The slots [lo, hi) whose state this data rank holds."""
        n, d = self.data
        if slots % n:
            raise ValueError(f"{slots} slots do not split over {n} data ranks of a "
                             f"{self.describe()} plan")
        per = slots // n
        return d * per, (d + 1) * per

    def owner(self, slot: int, slots: int) -> int:
        """The data rank holding `slot`."""
        return slot // (slots // self.data[0])

    def activation_context(self):
        """SERVING_RULES active for the model code over a "model" axis of
        more than one rank (with shard_model an untied lm_head holds this
        rank's vocab columns); nothing to do otherwise."""
        if self.model[0] == 1:
            return contextlib.nullcontext()
        return activation_sharding(self.mesh, SERVING_RULES, vocab_head=self.shard_model)

    # -- placement --------------------------------------------------------

    def place(self, model):
        """`model` (model_zoo.Model, whole weights) on this plan's device: itself
        when it is there already and nothing splits, else a copy of its
        module there (a replica on another card owns its weights). Over a
        "model" axis of M > 1 ranks the copy holds this rank's blocks of
        the weights the compute splits (block_specs), and its caches this
        rank's kv heads; a head count M does not divide raises."""
        m, r = self.model
        if m > 1 and any(k in model.cfg.block_pattern for k in ("attn", "local_attn")):
            tp.check_heads(model.cfg, m)
        if model.device == self.device and m == 1:
            return model
        lm = copy.deepcopy(model.lm).to(self.device)
        if m > 1:
            specs = self.block_specs(model)
            with torch.no_grad():
                for name, p in lm.named_parameters():
                    for d, entry in enumerate(specs[name]):
                        if entry == "model":
                            step = p.shape[d] // m
                            p.data = p.data.narrow(d, r * step, step).clone()
        return type(model)(cfg=model.cfg, lm=lm,
                           state=None if model.state is None else DecodeState(lm))

    # -- collectives of the engine's host loop ----------------------------

    def gather_data(self, x: torch.Tensor) -> torch.Tensor:
        """(D, *x.shape): every data rank's `x`, in rank order."""
        n, _ = self.data
        if n == 1:
            return x[None]
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=self.mesh.get_group("data"))
        return torch.stack(parts)

    def gather_snapshot(self, snapshot):
        """A snapshot of this rank's heads made whole over "model"."""
        if self.model[0] == 1:
            return snapshot
        with self.activation_context():
            return snapshot_map_heads(snapshot, lambda x: tp.gather(x, 1))

    def local_snapshot(self, snapshot):
        """A whole snapshot cut to this rank's heads (a copy: the stored
        snapshot is never written)."""
        m, r = self.model
        if m == 1:
            return snapshot

        def mine(x):
            step = x.shape[1] // m
            return x.narrow(1, r * step, step).clone()
        return snapshot_map_heads(snapshot, mine)

    def share(self, snapshot, owner: int, template):
        """The whole snapshot that data rank `owner` made, on every rank:
        broadcast over "data" from the owner (whose `snapshot` it is; the
        others pass None and a whole `template` of the same structure,
        which receives it). Every rank calls it at the same point."""
        n, d = self.data
        if n == 1:
            return snapshot
        out = snapshot if d == owner else template
        src = dist.get_global_rank(self.mesh.get_group("data"), owner)
        for x in (t for s in out for t in ([s] if torch.is_tensor(s) else s)
                  if torch.is_tensor(t)):
            dist.broadcast(x, src=src, group=self.mesh.get_group("data"))
        return out

    # -- specs ------------------------------------------------------------

    def param_specs(self, model) -> dict[str, tuple]:
        """{parameter name: spec}, the reference's. Tensor-parallel only
        when shard_model is set and the "model" axis has more than one
        device; only weights whose first logical axis (after an optional
        "layers" prefix) is "embed" are candidates: those split an output
        dim, never a contraction."""
        if not self.shard_model:
            return {n: () for n, _ in model.lm.named_parameters()}
        return self._embed_first_specs(model, PARAM_RULES)

    def block_specs(self, model) -> dict[str, tuple]:
        """{parameter name: spec} of what `place` stores: the heads and mlp
        blocks every "model" rank computes with, whether or not shard_model
        is set (without it the reference keeps every weight whole and
        computes the same heads from them), and with shard_model an untied
        lm_head's vocab columns (param_specs)."""
        rules = PARAM_RULES if self.shard_model else {
            k: v for k, v in PARAM_RULES.items() if k != "vocab"}
        return self._embed_first_specs(model, rules)

    def _embed_first_specs(self, model, rules):
        shapes = {n: tuple(p.shape) for n, p in model.lm.named_parameters()}
        if self.axis_sizes["model"] <= 1:
            return {n: () for n in shapes}
        axes = model.axes()

        def one(names, shape):
            body = names[1:] if names and names[0] == "layers" else names
            if body and body[0] == "embed":
                return spec_for(names, shape, self.mesh, rules)
            return ()
        return {n: one(axes[n], shape) for n, shape in shapes.items()}

    def state_specs(self, state) -> list:
        """The spec of every leaf of a model cache or of the engine's slot
        stack (a node of specs per layer; an int position's is ())."""
        def node_specs(node, axes):
            return type(node)(*(
                spec_for(names, tuple(x.shape), self.mesh, SERVING_RULES)
                if torch.is_tensor(x) else () for x, names in zip(node, axes)))
        return [node_specs(node, axes)
                for node, axes in zip(state, state_shard_axes(state))]

    def slot_spec(self, x) -> tuple:
        """A leading-slot-axis tensor (slot tokens, positions, keys,
        sampling params)."""
        names = ("batch",) + (None,) * (x.dim() - 1)
        return spec_for(names, tuple(x.shape), self.mesh, SERVING_RULES)


__all__ = ["PARAM_RULES", "SERVING_RULES", "ServePlan"]
