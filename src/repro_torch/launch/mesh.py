"""Mesh builders over ``torch.distributed``.

The port of the JAX package's ``launch/mesh.py``: a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the running ranks, one
process a device (``torchrun --nproc-per-node N``, or one process at world
1). Single pod: 16x16 = 256 ranks ("data", "model"); multi-pod: 2x16x16 =
512 ("pod", "data", "model"). Building one needs an initialised process
group whose world size is the mesh's size; nothing here touches device
state on import.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _device_type(device_type):
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def _ranks_running() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape, axes, device_type=None):
    """A DeviceMesh of `shape` named `axes` over every running rank; raises
    unless their number is the mesh's size."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    size = 1
    for s in shape:
        size *= s
    running = _ranks_running()
    if size != running:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} wants {size} ranks but "
                         f"{running} are running; start one process per device "
                         f"(torchrun --nproc-per-node {size})")
    return init_device_mesh(_device_type(device_type), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_serving_mesh(n_devices: int, model_parallel: int = 1, device_type=None):
    """("data", "model") mesh over the first ``n_devices`` ranks.

    Unlike make_production_mesh's fixed pod shapes, this validates against
    the ranks that are running and raises actionable errors on small
    hosts."""
    if n_devices < 1 or model_parallel < 1:
        raise ValueError(
            f"need n_devices >= 1 and model_parallel >= 1, got "
            f"{n_devices} and {model_parallel}")
    if n_devices % model_parallel != 0:
        raise ValueError(
            f"n_devices={n_devices} not divisible by "
            f"model_parallel={model_parallel}; the serving mesh is "
            "(data, model) = (n_devices // model_parallel, model_parallel)")
    avail = _ranks_running()
    if n_devices > avail:
        raise ValueError(
            f"mesh wants {n_devices} devices but only {avail} ranks are "
            f"running; start one process per device (torchrun "
            f"--nproc-per-node {n_devices})")
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(n_devices).reshape(n_devices // model_parallel, model_parallel)
    return DeviceMesh(_device_type(device_type), ranks, mesh_dim_names=("data", "model"))
