"""The production meshes (functions, not module constants: importing
this module touches no process group).

The port of the reference's ``launch/mesh.py`` on ``torch.distributed``:
``init_device_mesh`` over the default process group, which the caller
initialises first with the mesh's world size (NCCL ranks on the cards, or
the fake backend of the dry run)."""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """Single pod: (16, 16) = 256 devices, dims (data, model). Multi-pod:
    (2, 16, 16) = 512 devices, dims (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_host_mesh(n_devices: int | None = None, model_axis: int = 1, device_type: str = "cuda"):
    """A (n // model_axis, model_axis) ("data", "model") mesh over the
    default group's ranks (``n_devices``: all of them by default)."""
    n = n_devices or dist.get_world_size()
    return init_device_mesh(device_type, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))
