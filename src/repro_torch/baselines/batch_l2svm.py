"""Full-batch l2-SVM — the paper's "libSVM (batch)" reference column.

Solves exactly the primal the paper states (eq. 1-2, unbiased):

    min_w  ||w||^2 + C sum_i max(0, 1 - y_i w.x_i)^2

The objective is smooth (squared hinge) and strongly convex, so full-batch
Nesterov gradient descent with a Lipschitz-based step converges to high
precision; no QP library is required. All data in memory, many passes —
deliberately NOT a streaming algorithm (it is the accuracy ceiling).

f32, as the reference; the products are ``torch.matmul`` (the reference
leaves them to XLA, outside any Pallas kernel), and the loops keep every
scalar on the device: no host synchronisation until the caller reads.
"""
from __future__ import annotations

import math

import torch

from .._device import as_tensor, pick_device


def fit_batch_l2svm(X, y, c: float, iters: int = 2000, *, device=None):
    """Returns (w, objective). Nesterov accelerated GD, fixed L-based step."""
    dev = pick_device(device, X, y)
    X, y = as_tensor(X, dev, torch.float32), as_tensor(y, dev, torch.float32)
    N, D = X.shape
    c = torch.as_tensor(c, dtype=X.dtype, device=dev)

    def obj_grad(w, with_obj=False):
        margin = 1.0 - y * (X @ w)
        act = torch.clamp(margin, min=0.0)
        grad = 2.0 * w - 2.0 * c * ((act * y) @ X)
        return (w @ w + c * torch.sum(act**2) if with_obj else None), grad

    # Lipschitz constant of the gradient: 2 + 2 C lambda_max(X^T X)
    # power iteration for lambda_max
    v = torch.ones(D, dtype=X.dtype, device=dev) / math.sqrt(D)
    for _ in range(50):
        v = X.T @ (X @ v)
        v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)
    lam_max = torch.linalg.vector_norm(X.T @ (X @ v))
    step = 1.0 / (2.0 + 2.0 * c * lam_max)

    w = torch.zeros(D, dtype=X.dtype, device=dev)
    z, t = w, torch.ones((), dtype=X.dtype, device=dev)
    for _ in range(iters):
        _, gz = obj_grad(z)
        w_next = z - step * gz
        t_next = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        z = w_next + ((t - 1.0) / t_next) * (w_next - w)
        w, t = w_next, t_next
    obj, _ = obj_grad(w, with_obj=True)
    return w, obj
