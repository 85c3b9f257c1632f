"""ServePlan: where the serving stack's tensors live.

The port of the JAX package's ``serve/plan.py``. One object answers the
engine's placement questions: the device it serves on, how parameters
would split for tensor parallelism on the "model" axis, and how
slot-stacked caches and per-slot sampling state would spread over the
"data" axis. The specs come from the port's
``distributed/sharding.spec_for`` under the reference's two rule tables,
so each equals the reference's ``PartitionSpec`` entry for entry.

A plan over one device is the path the port serves on: every spec is
then replicated in effect (each named axis has size 1), and the engine
runs on ``plan.device``. ``ServePlan.single_device(device)`` needs no
process group; ``serve/replicas.replica_plans`` gives each replica one,
on its own card when there are enough. A plan of more than one device
(data-sharded slots, tensor-parallel compute over ranks) is ROADMAP A.9
item 3; ``ServeEngine`` refuses one.

Bit-parity contract (the reference's): SERVING_RULES names only the
batch/slot dim ("data") and the head dims ("model"), and PARAM_RULES only
the output dims of dense weights whose first logical axis is "embed"
(wq/wk/wv on heads, the GLU's wi/wg on mlp, lm_head on vocab), so no
split would change the operand order of a floating-point reduction.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass

import torch

from repro_torch.core.state import DecodeState, state_shard_axes
from repro_torch.distributed.sharding import mesh_axis_sizes, spec_for

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
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


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
        return cls.from_mesh(make_serving_mesh(data * model, model),
                             shard_model=shard_model, device=device)

    @classmethod
    def single_device(cls, device=None):
        """The 1x1 plan on `device` (default: the current card, else the
        CPU); no process group needed."""
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

    # -- placement --------------------------------------------------------

    def place(self, model):
        """`model` (model_zoo.Model) on this plan's device: itself when it
        is there already, else a copy of its module there (a replica on
        another card owns its weights)."""
        if model.device == self.device:
            return model
        lm = copy.deepcopy(model.lm).to(self.device)
        return type(model)(cfg=model.cfg, lm=lm,
                           state=None if model.state is None else DecodeState(lm))

    # -- specs ------------------------------------------------------------

    def param_specs(self, model) -> dict[str, tuple]:
        """{parameter name: spec}. Tensor-parallel only when shard_model is
        set and the "model" axis has more than one device; only weights
        whose first logical axis (after an optional "layers" prefix) is
        "embed" are candidates: those split an output dim, never a
        contraction."""
        shapes = {n: tuple(p.shape) for n, p in model.lm.named_parameters()}
        axes = model.axes()
        if not self.shard_model or self.axis_sizes["model"] <= 1:
            return {n: () for n in shapes}

        def one(names, shape):
            body = names[1:] if names and names[0] == "layers" else names
            if body and body[0] == "embed":
                return spec_for(names, shape, self.mesh, PARAM_RULES)
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
