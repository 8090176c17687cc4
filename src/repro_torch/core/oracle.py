"""Explicit augmented-space simulator — the ground-truth oracle for tests.

Stores the *full* center [w ; sigma] with one slack coordinate per example
(O(N) memory — exactly what StreamSVM avoids) and runs Algorithm 1 literally
in that space. Tests assert that streamsvm.fit's O(D) recursion
reproduces this simulator's (w, R, ||sigma||^2, M) to float tolerance.

Pure numpy, float64 — deliberately independent of the port's torch code;
a copy of the reference's ``repro/core/oracle.py`` (the port imports
nothing of ``repro``).
"""
from __future__ import annotations

import numpy as np


def fit_explicit(X, y, c, variant: str = "exact"):
    """Returns dict(w, r, xi2, m, sigma). X: (N,D) y: (N,) in ±1."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    N, D = X.shape
    c_inv = 1.0 / c
    root = np.sqrt(c_inv) if variant == "exact" else 1.0

    w = y[0] * X[0].copy()
    sigma = np.zeros(N)
    sigma[0] = root  # first point's slack coordinate
    r = 0.0
    m = 1
    for n in range(1, N):
        p_feat = y[n] * X[n]
        # augmented distance: point n has slack coord root at index n
        diff2 = np.sum((w - p_feat) ** 2)
        slack2 = np.sum(sigma**2) - 2.0 * sigma[n] * root + root**2
        d = np.sqrt(diff2 + slack2)
        if d >= r:
            s = 0.5 * (1.0 - r / d)
            w = w + s * (p_feat - w)
            sigma = (1.0 - s) * sigma
            sigma[n] += s * root
            r = r + 0.5 * (d - r)
            m += 1
    return dict(w=w, r=r, xi2=float(np.sum(sigma**2)), m=m, sigma=sigma)


def meb_brute(points, iters: int = 20000):
    """High-iteration Badoiu–Clarkson MEB of a point set (reference optimum)."""
    P = np.asarray(points, np.float64)
    c = P.mean(axis=0)
    for t in range(1, iters + 1):
        d = np.linalg.norm(P - c, axis=1)
        f = int(np.argmax(d))
        c = c + (P[f] - c) / (t + 1.0)
    return c, float(np.max(np.linalg.norm(P - c, axis=1)))
