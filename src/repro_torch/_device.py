"""Device policy shared by every entry point of the port.

``device=None`` means ``"cuda"``. Numpy inputs (and Python scalars) are
placed on that device; torch tensors stay where they are unless the caller
names a device. So a CPU tensor, or ``device="cpu"``, is the caller asking
for the CPU. There is no fallback: on a machine without CUDA, placing a
numpy input on the default device raises.
"""
from __future__ import annotations

import torch


def pick_device(device=None, *likes) -> torch.device:
    """The device a call runs on: ``device`` if given, else the first torch
    tensor among ``likes``, else CUDA."""
    if device is not None:
        return torch.device(device)
    for x in likes:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cuda")


def as_tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``device`` (a tensor already there is not copied)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(x, dtype=dtype, device=device)
