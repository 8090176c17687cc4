"""Carry ball state between numpy (and anything numpy can read) and the port.

``ball_from_numpy`` takes any object with ``w, r, xi2, m`` attributes, or a
4-tuple ``(w, r, xi2, m)``, and returns a port ``Ball`` on ``device``;
``ball_to_numpy`` goes the other way. The tests use these to hand the JAX
reference's state to the port and back, through numpy arrays only.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import pick_device
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
