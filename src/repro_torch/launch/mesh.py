"""Production meshes, the JAX package's ``launch/mesh.py`` on
``torch.distributed``. Defined as FUNCTIONS, so importing this module
touches no process group: the caller opens one first (the dry run a
``fake`` group of 256 or 512 ranks, a launcher a real one)."""
from __future__ import annotations

import math


def make_production_mesh(multi_pod: bool = False, device_type: str = "cpu"):
    """Single pod: (16, 16) = 256 devices ("data", "model").
    Multi-pod: (2, 16, 16) = 512 devices ("pod", "data", "model"); the pod
    axis is pure data parallelism across pods."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have {have}: open a process "
            f"group of {n} ranks first (the dry run opens a fake one)")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_smoke_mesh(device_type: str = "cpu"):
    """1 x 1 mesh with the production axis names (a 1-rank group)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=("data", "model"))
