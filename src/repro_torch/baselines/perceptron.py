"""Rosenblatt perceptron, single pass, unbiased (matches paper setup)."""
from __future__ import annotations

import torch

from .._device import as_tensor, pick_device
from ..kernels.baselines import perceptron_scan, perceptron_scan_plain


def fit_perceptron(X, y, *, device=None):
    """Returns (w, n_updates). X: (N, D), y: (N,) ±1. One launch of kernel
    P1 on the card; its plain version on the CPU."""
    dev = pick_device(device, X, y)
    return perceptron_scan(as_tensor(X, dev, torch.float32), as_tensor(y, dev, torch.float32))


def fit_perceptron_plain(X, y, *, device=None):
    """``fit_perceptron`` through the plain version on any device (the row
    loop P1 is held to)."""
    dev = pick_device(device, X, y)
    return perceptron_scan_plain(as_tensor(X, dev, torch.float32),
                                 as_tensor(y, dev, torch.float32))
