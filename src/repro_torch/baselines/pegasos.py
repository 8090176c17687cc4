"""Pegasos (primal estimated sub-gradient SVM), single sweep, block size k.

Paper setup: "We make the Pegasos implementation do a single sweep over data
and have a user chosen block size k" (k=1, k=20). lambda maps from the SVM C
as lambda = 1/(C N) (standard correspondence).
"""
from __future__ import annotations

import torch

from .._device import as_tensor, pick_device
from ..kernels.baselines import pegasos_scan, pegasos_scan_plain


def _blocks(X, y, k, device):
    dev = pick_device(device, X, y)
    X, y = as_tensor(X, dev, torch.float32), as_tensor(y, dev, torch.float32)
    T = X.shape[0] // int(k)
    return X[: T * k], y[: T * k]


def fit_pegasos(X, y, lam: float, k: int = 1, *, device=None):
    """Single sweep in stream order with blocks of size k. Returns w.

    Truncates the trailing partial block (paper semantics unspecified; at
    N >= 4000 and k <= 20 this is < 0.5% of the data). One launch of kernel
    P2 on the card; its plain version on the CPU.
    """
    Xt, yt = _blocks(X, y, k, device)
    return pegasos_scan(Xt, yt, float(lam), int(k))


def fit_pegasos_plain(X, y, lam: float, k: int = 1, *, device=None):
    """``fit_pegasos`` through the plain version on any device (the step
    loop P2 is held to)."""
    Xt, yt = _blocks(X, y, k, device)
    return pegasos_scan_plain(Xt, yt, float(lam), int(k))
