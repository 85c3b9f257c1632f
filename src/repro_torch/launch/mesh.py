"""Mesh builders over ``torch.distributed``.

The port of the JAX package's ``launch/mesh.py``: a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the running ranks, one
process a device (``torchrun --nproc-per-node N``, or one process at world
1). Single pod: 16x16 = 256 ranks ("data", "model"); multi-pod: 2x16x16 =
512 ("pod", "data", "model"). Building one needs an initialised process
group whose world size is the mesh's size (``init_ranks``); nothing here
touches device state on import. The device type is the port's rule
(``utils.resolve_device``): CUDA unless the caller names another, and an
error without a card.

``init_ranks(device, share_card=True)`` is the explicit opt-in for ranks
that share one card: every rank on ``cuda:0`` and gloo, whose
collectives move CUDA tensors through the host. It is never chosen on
its own (NCCL refuses two ranks on one GPU); it exists so that a
multi-rank path can run on a one-card machine, as the reference forces
host devices on the CPU (``--xla_force_host_platform_device_count``).
"""
from __future__ import annotations

import logging
import os
import socket

import torch
import torch.distributed as dist

from repro_torch.utils import resolve_device

log = logging.getLogger("repro_torch.mesh")


def _device_type(device_type):
    return resolve_device(device_type).type


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_ranks(device, *, share_card: bool = False):
    """This process's device for a mesh run, the process group joined if
    the caller has not: from torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT), or alone at world 1 on a free loopback
    port. NCCL on CUDA (one card a rank: LOCAL_RANK's), gloo on the CPU;
    with `share_card` every rank runs on cuda:0 over gloo. Returns
    (device, whether this call joined the group)."""
    dev = resolve_device(device)
    if share_card and dev.type != "cuda":
        raise SystemExit("--share-card shares a CUDA card; drop it with --device cpu")
    owned = not dist.is_initialized()
    if owned:
        backend = "nccl" if dev.type == "cuda" and not share_card else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                                    rank=0, world_size=1)
    if dev.type == "cuda":
        world, cards = dist.get_world_size(), torch.cuda.device_count()
        if share_card:
            dev = torch.device("cuda", 0)
            log.info("--share-card: %d ranks share %s over gloo (collectives staged "
                     "through the host; not a multi-card speed)", world, dev)
        elif world > cards:
            if owned:
                dist.destroy_process_group()
            raise SystemExit(f"--mesh with --device cuda runs one rank a card: {world} "
                             f"ranks but {cards} visible cards (NCCL cannot put two "
                             "ranks on one GPU); pass --share-card to run them on one "
                             "card over gloo, or run on the CPU")
        else:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", dist.get_rank())))
        torch.cuda.set_device(dev)
        torch.cuda.init()
    return dev, owned


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
