"""Feature preprocessing — makes the MEB<->SVM theory's assumption hold.

The port's own copy of ``repro/data/preprocess.py`` (numpy only).

The reduction requires K(x,x) = kappa constant; for the linear kernel that
means L2-normalized inputs ("dot product (normalized inputs)", paper Sec 3).
We additionally (a) center dense features on the train mean — the unbiased
classifier otherwise degenerates on all-positive feature spaces (every pair
of unit rows has a non-negative dot product, so any single-example-dominated
center classifies everything as one class), and (b) optionally append a
constant bias coordinate *before* normalization, the standard augmentation
for the "biased" extension the paper mentions. Both preserve K(x,x)=1.

Sparse datasets (w3a) are not centered, matching standard SVM practice.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# per-dataset policy: (center, bias_feature)
POLICY: Dict[str, Tuple[bool, bool]] = {
    "synthetic_a": (True, False),
    "synthetic_b": (True, False),
    "synthetic_c": (True, False),
    "waveform": (True, False),
    "mnist01": (True, False),
    "mnist89": (True, False),
    "ijcnn": (True, True),
    "w3a": (False, False),
}


def l2_normalize(X: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(X, axis=1, keepdims=True)
    return X / np.maximum(n, 1e-8)


def preprocess(Xtr, Xte, *, center: bool = True, bias: bool = False):
    Xtr = np.asarray(Xtr, np.float32)
    Xte = np.asarray(Xte, np.float32)
    if center:
        mu = Xtr.mean(axis=0, keepdims=True)
        Xtr, Xte = Xtr - mu, Xte - mu
    if bias:
        Xtr = np.hstack([Xtr, np.ones((len(Xtr), 1), np.float32)])
        Xte = np.hstack([Xte, np.ones((len(Xte), 1), np.float32)])
    return l2_normalize(Xtr), l2_normalize(Xte)


def preprocess_for(name: str, Xtr, Xte):
    center, bias = POLICY.get(name, (True, False))
    return preprocess(Xtr, Xte, center=center, bias=bias)
