"""CVM (Tsang et al. 2005) — batch core-set MEB SVM in the augmented space.

Badoiu-Clarkson core-set outer loop: each iteration scans the WHOLE dataset
for the farthest augmented point from the current center (= one data pass,
Fig 2's x-axis), adds it to the core set, and re-solves the core-set MEB.
Stops at (1+eps) enclosure or max_passes.

The core-set MEB is solved in explicit (D + |core|)-dim coordinates (each
core point owns one slack dimension) with Frank-Wolfe/BC iterations — the
same solver family CVM uses. Records the weight vector after every pass so
Fig 2 can plot accuracy-vs-passes against one StreamSVM pass.

float64 on the device, with the reference's operations in its order. Each
pass's scan over the N augmented rows runs on the device; the solver's
argmax stays a device index through its iterations, and a pass makes one
host synchronisation (the farthest row, its distance and the radius, for
the stop test and the core-set membership test).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import as_tensor, pick_device


def _d2(P, u, sigma, root, c_inv):
    """The squared augmented distances of the rows of P (with slacks
    ``sigma``) to the center (u, sigma): the reference's expression."""
    diff = P - u
    return (diff * diff).sum(1) + torch.sum(sigma**2) - 2.0 * root * sigma + c_inv


def _solve_core_meb(P, c_inv: float, iters: int = 2000):
    """MEB of core rows P (m, D) with per-point slack sqrt(c_inv)e_i.

    Returns (u (D,), sigma (m,), r), r a 0-d device tensor. Explicit BC in
    D+m dims.
    """
    m, _ = P.shape
    root = math.sqrt(c_inv)
    u = P.mean(dim=0)
    sigma = torch.full((m,), root / m, dtype=P.dtype, device=P.device)
    for t in range(1, iters + 1):
        f = torch.argmax(_d2(P, u, sigma, root, c_inv)).reshape(1)
        eta = 1.0 / (t + 1.0)
        u += eta * (P.index_select(0, f)[0] - u)
        sigma *= 1.0 - eta
        sigma.index_put_((f,), sigma.index_select(0, f) + eta * root)
    d2 = _d2(P, u, sigma, root, c_inv)
    return u, sigma, torch.sqrt(torch.clamp(d2.max(), min=0.0))


def fit_cvm(X, y, C: float, eps: float = 1e-3, max_passes: int = 64,
            solver_iters: int = 2000, *, device=None):
    """Returns dict(w, r, core_idx, passes, w_per_pass): w (D,) and each of
    w_per_pass float64 device tensors, r a float, core_idx an int64 device
    tensor, passes an int."""
    dev = pick_device(device, X, y)
    X, y = as_tensor(X, dev, torch.float64), as_tensor(y, dev, torch.float64)
    YX = y[:, None] * X
    N, _ = X.shape
    c_inv = 1.0 / C
    root = math.sqrt(c_inv)

    core = [0]
    u = YX[0].clone()
    sigma = torch.full((1,), root, dtype=torch.float64, device=dev)
    r = torch.zeros((), dtype=torch.float64, device=dev)
    w_per_pass = []
    passes = 0
    sig_map = torch.zeros(N, dtype=torch.float64, device=dev)
    sig_map[0] = sigma[0]

    for _ in range(max_passes):
        # one full data pass: farthest augmented point from current center
        diff = YX - u
        d2_all = (diff * diff).sum(1) + torch.sum(sigma**2) - 2.0 * root * sig_map + c_inv
        passes += 1
        w_per_pass.append(u.clone())
        f = torch.argmax(d2_all)
        f_host, d2_far, r_host = torch.stack([f.double(), d2_all.max(), r]).tolist()
        f = int(f_host)
        d_far = math.sqrt(max(d2_far, 0.0))
        if d_far <= (1.0 + eps) * r_host:
            break
        if f not in core:
            core.append(f)
        idx = torch.as_tensor(core, dtype=torch.int64, device=dev)
        u, sigma, r = _solve_core_meb(YX.index_select(0, idx), c_inv, iters=solver_iters)
        sig_map = torch.zeros(N, dtype=torch.float64, device=dev)
        sig_map[idx] = sigma

    return dict(w=u, r=float(r), core_idx=torch.as_tensor(core, dtype=torch.int64, device=dev),
                passes=passes, w_per_pass=w_per_pass)
