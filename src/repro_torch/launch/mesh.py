"""Production and debug meshes over the current process group.

The port of ``repro.launch.mesh``.  The meshes are ``DeviceMesh``es over
the default process group, which the caller has set up (``torchrun`` and
``dist.init_process_group``, or, for the dry run, PyTorch's fake group of
the production size).  This module touches no process group at import
time: the meshes are functions.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a process group of {math.prod(shape)} "
                           "ranks; none is initialised")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise RuntimeError(f"a {shape} mesh needs a process group of {math.prod(shape)} "
                           f"ranks; this one has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """Single pod: (16, 16) = 256 devices, axes (data, model).
    Multi-pod:  (2, 16, 16) = 512 devices, axes (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 4, device_type: str = "cuda") -> DeviceMesh:
    """Small mesh for sharded integration tests (8 ranks)."""
    return _mesh((n_data, n_model), ("data", "model"), device_type)
