"""Mesh factories: a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names.

Reference: ``repro/launch/mesh.py``.  Functions, not a module-level
constant: importing this module touches no process group.  Each function
needs one started (``torch.distributed.init_process_group``, or the
environment of ``torch.distributed.run``, from which `init_distributed`
starts one) and builds its mesh over the group's ranks in rank order, so
that a rank's mesh coordinates are those of the reference's device at the
same position of ``jax.make_mesh``'s device array.

The device type is ``"cuda"`` unless the caller passes
``device_type="cpu"``; on the card each rank first takes its own device
(``torch.cuda.set_device(local_rank)``).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def init_distributed(device_type: str = "cuda") -> int:
    """Start the default process group from ``torch.distributed.run``'s
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) unless one is started: NCCL on the card, gloo on the
    CPU.  On the card the rank first takes the device ``LOCAL_RANK``.
    Returns the rank."""
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    return dist.get_rank()


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda") -> DeviceMesh:
    """Any factorization of the world size (``--mesh 8x4 --axes
    data,model``); raises when the shape's product is not the world
    size."""
    if int(np.prod(shape)) != dist.get_world_size():
        raise ValueError(f"a mesh of {tuple(shape)} over a world of "
                         f"{dist.get_world_size()}")
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def local_mesh(n_data: int = 1, n_model: int = 1,
               device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over the world's ranks (tests)."""
    return make_mesh((n_data, n_model), ("data", "model"), device_type)

