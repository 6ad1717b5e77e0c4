"""Production and debug meshes over the default process group.

Port of ``repro/launch/mesh.py``: a ``DeviceMesh`` over ("data", "model")
= (16, 16), or ("pod", "data", "model") = (2, 16, 16), on the first ranks
of the default process group.  Importing this module touches no
distributed state; the caller initializes the process group (NCCL on
cards, gloo or the fake process group on the CPU) and the mesh is built
inside the functions.  The device type defaults to ``cuda``.
"""

from __future__ import annotations

import math


def _mesh(device_type: str, shape, axes):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} needs {need} devices; only "
            f"{have} available (ranks of the default process group)")
    return DeviceMesh(device_type, torch.arange(need).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 single-pod or 2x16x16 multi-pod mesh.

    The 'pod' axis is pure data parallelism, 'data' hosts DP/FSDP,
    'model' hosts TP/EP.  Uses the first prod(shape) ranks, so a 512-rank
    process group serves both variants."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_debug_mesh(data: int = 1, model: int = 1, *,
                    device_type: str = "cuda"):
    """Small ("data", "model") mesh on the first data * model ranks."""
    return _mesh(device_type, (data, model), ("data", "model"))
