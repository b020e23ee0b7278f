"""Device meshes over an initialised process group.

Port of ``repro/launch/mesh.py``: a mesh is ``init_device_mesh`` over the
process group, one rank a device, with the planner's axis names. The
caller initialises the group (``torch.distributed.init_process_group``
with its address, world size and rank); the mesh's size must be the
world's. On ``cuda`` each rank takes the card ``rank % device_count``,
and a mesh larger than the cards of this host raises: nothing falls back
to the CPU. Importing this module touches no device.
"""
from __future__ import annotations

import math
import socket
from typing import Sequence

import torch
import torch.distributed as dist


def local_init_method() -> str:
    """A ``tcp://`` rendezvous on this host, on a port free just now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    return f"tcp://127.0.0.1:{port}"


def make_mesh(shape: Sequence[int], axes: Sequence[str], device="cuda"):
    """Any (data, model) / (pod, data, model) factorisation of the world
    (tests and elastic restarts)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not name axes {axes}")
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group")
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the world has "
                         f"{dist.get_world_size()}")
    dev_type = torch.device(device).type
    if dev_type == "cuda":
        cards = torch.cuda.device_count()
        if n > cards:
            raise RuntimeError(f"a {shape} mesh needs {n} CUDA devices; "
                               f"this host has {cards}")
        torch.cuda.set_device(dist.get_rank() % cards)
    return init_device_mesh(dev_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's production meshes: (16, 16) ``("data", "model")``
    or (2, 16, 16) ``("pod", "data", "model")``; any other world raises."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)
