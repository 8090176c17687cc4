"""Device policy shared by every entry point of the port.

``device=None`` means ``"cuda"``. Numpy inputs (and Python scalars) are
placed on that device; torch tensors stay where they are unless the caller
names a device. So a CPU tensor, or ``device="cpu"``, is the caller asking
for the CPU. There is no fallback: on a machine without CUDA, placing a
numpy input on the default device raises.

``inference()`` is the context the models' ``prefill`` and ``decode_step``
run in: ``torch.inference_mode()``, unless a caller put another in its
place for a block with ``inference_as`` (the dry run's meta DTensors cannot
be made in inference mode, so it runs them under ``torch.no_grad()``).
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

_INFERENCE = contextvars.ContextVar("repro_torch_inference", default=torch.inference_mode)


def inference():
    """A new context manager of the kind ``inference_as`` set, by default
    ``torch.inference_mode()``."""
    return _INFERENCE.get()()


@contextlib.contextmanager
def inference_as(factory):
    """Inside the block, ``inference()`` returns ``factory()`` (for example
    ``torch.no_grad``)."""
    token = _INFERENCE.set(factory)
    try:
        yield
    finally:
        _INFERENCE.reset(token)


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
