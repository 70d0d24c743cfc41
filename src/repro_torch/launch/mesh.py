"""Mesh construction over the process group the caller initialized.

Functions, not module-level constants, so importing this module touches no
process group.  The mesh's device type follows ``current_device()`` unless
the caller names one (the dry run builds a ``"cpu"`` mesh over a fake world
while its tensors stay on ``meta``).
"""
from __future__ import annotations

import math

import torch.distributed as dist


def _mesh(shape, axes, device_type=None):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.device import current_device
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed.init_process_group first")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks, the world has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type or current_device().type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """The reference's logical layout, (16, 16) over ("data", "model") or
    (2, 16, 16) over ("pod", "data", "model"): the shape of its TPU v5e pods,
    kept as a logical layout, not a claim about an H100 cluster.  Needs a
    world of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device_type: str | None = None):
    """Small mesh for tests over a world of ``prod(shape)`` ranks."""
    return _mesh(shape, axes, device_type)
