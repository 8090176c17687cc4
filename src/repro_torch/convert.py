"""Carry ball state between numpy (and anything numpy can read) and the port.

``ball_from_numpy`` takes any object with ``w, r, xi2, m`` attributes, or a
4-tuple ``(w, r, xi2, m)``, and returns a port ``Ball`` on ``device``;
``ball_to_numpy`` goes the other way. ``kernel_bank_from_numpy`` and
``kernel_bank_to_numpy`` do the same for a KernelBank's 7 leaves. The tests
use these to hand the JAX reference's state to the port and back, through
numpy arrays only.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import pick_device
from .core.kernel_bank import KernelBank
from .core.meb import Ball


def ball_from_numpy(obj, device=None) -> Ball:
    """A port ``Ball`` (w, r, xi2 float32; m int32) on ``device`` (None: CUDA)."""
    parts = (obj.w, obj.r, obj.xi2, obj.m) if hasattr(obj, "w") else tuple(obj)
    if len(parts) != 4:
        raise ValueError(f"a ball has 4 leaves (w, r, xi2, m); got {len(parts)}")
    dev = pick_device(device)
    w, r, xi2, m = (np.asarray(p) for p in parts)
    return Ball(
        w=torch.as_tensor(w.astype(np.float32), device=dev),
        r=torch.as_tensor(r.astype(np.float32), device=dev),
        xi2=torch.as_tensor(xi2.astype(np.float32), device=dev),
        m=torch.as_tensor(m.astype(np.int32), device=dev),
    )


def ball_to_numpy(ball: Ball) -> tuple:
    """``(w, r, xi2, m)`` as host numpy arrays."""
    return tuple(x.detach().cpu().numpy() for x in ball)


_KB_DTYPES = (np.int32, np.float32, np.float32, np.float32, np.float32, np.float32, np.int32)


def kernel_bank_from_numpy(obj, device=None) -> KernelBank:
    """A port ``KernelBank`` on ``device`` (None: CUDA) from any object with
    its 7 fields (idx, coef, points, q, r, xi2, m), or a 7-tuple of arrays;
    idx and m int32, the rest float32."""
    fields = KernelBank._fields
    parts = tuple(getattr(obj, f) for f in fields) if hasattr(obj, "coef") else tuple(obj)
    if len(parts) != len(fields):
        raise ValueError(f"a KernelBank has 7 leaves {fields}; got {len(parts)}")
    dev = pick_device(device)
    return KernelBank(*(
        torch.as_tensor(np.asarray(p).astype(dt), device=dev) for p, dt in zip(parts, _KB_DTYPES)
    ))


def kernel_bank_to_numpy(bank: KernelBank) -> tuple:
    """The 7 leaves ``(idx, coef, points, q, r, xi2, m)`` as host numpy arrays."""
    return tuple(x.detach().cpu().numpy() for x in bank)
