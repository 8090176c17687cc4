"""Kernelized StreamSVM (paper Sec 4.2): the dense O(N)-state engine.

Keeps the N-vector of Lagrange coefficients alpha (the center is
c = sum_m alpha_m phi(x_m)); each example costs O(N) kernel evaluations.
This gives up the constant-memory property (as the paper notes) but keeps
the single pass. For the linear kernel it is algebraically Algorithm 1:
w = X^T alpha (``linear_weights``).

``fit_kernelized`` is a per-row loop of plain torch: it is the reference
engine that the bounded core-set bank (``kernel_bank.fit_kernel_bank``)
reproduces when its buffer holds every row, not a path of the bank, and
the JAX package has no Pallas kernel for it.

Kernels must satisfy K(x, x) = kappa (constant); linear assumes normalized
inputs only for the theory, the algorithm runs regardless.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .._device import as_tensor, pick_device


class KernelBall(NamedTuple):
    alpha: torch.Tensor  # (N,) signed coefficients (include label sign)
    q: torch.Tensor  # () running |c|^2 = alpha^T K alpha
    r: torch.Tensor  # () radius
    xi2: torch.Tensor  # () slack-block squared norm
    m: torch.Tensor  # () int32 core-vector count


def linear_kernel(A, B):
    return A @ B.T


def rbf_kernel(gamma):
    def k(A, B):
        a2 = torch.sum(A * A, -1)[:, None]
        b2 = torch.sum(B * B, -1)[None, :]
        # Clamp the squared distance at 0: near-duplicate rows make the
        # expansion go slightly negative in f32, which would give
        # K(x, x') > kappa. The Gram epilogue (kernel B5) clamps the same way.
        d2 = torch.clamp(a2 + b2 - 2.0 * A @ B.T, min=0.0)
        return torch.exp(-gamma * d2)

    return k


def fit_kernelized(X, y, c: float, kernel_fn: Callable = linear_kernel,
                   variant: str = "exact", *, device=None) -> KernelBall:
    """One pass over (X, y), y in {-1, +1}; row 0 seeds the ball. alpha is
    zero for unseen rows, so g_n = alpha . k(X, x_n) over the whole row is
    exact at step n. Returns a KernelBall of tensors on the inputs' device."""
    dev = pick_device(device, X, y)
    X, y = as_tensor(X, dev, torch.float32), as_tensor(y, dev, torch.float32)
    n = X.shape[0]
    c_inv = torch.tensor(1.0 / c, dtype=torch.float32, device=dev)
    gain = c_inv if variant == "exact" else torch.ones((), dtype=torch.float32, device=dev)
    kdiag = torch.stack([kernel_fn(X[i : i + 1], X[i : i + 1])[0, 0] for i in range(n)])
    alpha = torch.zeros((n,), dtype=torch.float32, device=dev)
    alpha[0] = y[0]
    q, r, xi2 = kdiag[0].clone(), torch.zeros((), device=dev), gain.clone()
    m = 1
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 kernel rows
    for i in range(1, n):
        yn = y[i]
        kn = kernel_fn(X, X[i : i + 1])[:, 0]
        g = torch.dot(alpha, kn)
        d2 = q - 2.0 * yn * g + kdiag[i] + xi2 + c_inv
        d = torch.sqrt(torch.clamp(d2, min=1e-12))
        if not bool(d >= r):
            continue
        s = 0.5 * (1.0 - r / d)
        alpha = alpha * (1.0 - s)
        alpha[i] = alpha[i] + s * yn
        q = (1.0 - s) ** 2 * q + 2.0 * s * (1.0 - s) * yn * g + s**2 * kdiag[i]
        r = r + 0.5 * (d - r)
        xi2 = xi2 * (1.0 - s) ** 2 + s**2 * gain
        m += 1
    return KernelBall(alpha=alpha, q=q, r=r, xi2=xi2,
                      m=torch.tensor(m, dtype=torch.int32, device=dev))


def decision_function(kb: KernelBall, X_train, X_test, kernel_fn: Callable = linear_kernel):
    return kernel_fn(X_test, X_train) @ kb.alpha


def linear_weights(kb: KernelBall, X_train) -> torch.Tensor:
    """For the linear kernel, c = X^T alpha: Algorithm 1's w."""
    return X_train.T @ kb.alpha
