"""Datasets for the paper's Table 1, generated offline (numpy only).

The port's own copy of ``repro/data/synthetic.py``: the same generators,
so the same seed gives the same arrays in both packages.

Synthetic A/B/C and Waveform are genuinely synthetic in the paper too and are
generated to the paper's specs (dims, sizes, ~85% separability for A/B/C;
Waveform is the classic CART generator). MNIST / IJCNN / w3a are real datasets
that are not downloaded — we substitute *spec-matched surrogates* (same
dimensionality, train/test sizes, class balance, and a difficulty profile
tuned so the batch-SVM ceiling lands near the paper's libSVM column).

All generators are deterministic given `seed`.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

Arrays = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def _split(X, y, n_train, n_test, rng):
    idx = rng.permutation(len(y))
    X, y = X[idx], y[idx]
    return (
        X[:n_train].astype(np.float32),
        y[:n_train].astype(np.float32),
        X[n_train : n_train + n_test].astype(np.float32),
        y[n_train : n_train + n_test].astype(np.float32),
    )


def _gauss_clusters(
    rng, n, dim, centers_pos, centers_neg, scale
) -> Tuple[np.ndarray, np.ndarray]:
    half = n // 2
    Xp = np.concatenate(
        [
            rng.normal(loc=c, scale=scale, size=(half // len(centers_pos), dim))
            for c in centers_pos
        ]
    )
    Xn = np.concatenate(
        [
            rng.normal(loc=c, scale=scale, size=(half // len(centers_neg), dim))
            for c in centers_neg
        ]
    )
    X = np.concatenate([Xp, Xn])
    y = np.concatenate([np.ones(len(Xp)), -np.ones(len(Xn))])
    return X, y


def synthetic_a(seed=0) -> Arrays:
    """2-D, two normally distributed clusters, ~96% linearly separable."""
    rng = np.random.default_rng(seed)
    X, y = _gauss_clusters(
        rng, 20200, 2, centers_pos=[[1.2, 1.2]], centers_neg=[[-1.2, -1.2]], scale=1.0
    )
    return _split(X, y, 20000, 200, rng)


def synthetic_b(seed=0) -> Arrays:
    """3-D asymmetric flipped mixture — linear ceiling ~66% (paper: 66.0)."""
    rng = np.random.default_rng(seed)
    n = 20200
    npos = n // 2
    frac = 0.65
    mu = np.array([1.0, 1.0, 0.5]) * 1.2
    nmain = int(frac * npos)
    Xp = np.vstack(
        [rng.normal(size=(nmain, 3)) + mu, rng.normal(size=(npos - nmain, 3)) - mu]
    )
    Xn = np.vstack(
        [rng.normal(size=(nmain, 3)) - mu, rng.normal(size=(npos - nmain, 3)) + mu]
    )
    X = np.vstack([Xp, Xn])
    y = np.concatenate([np.ones(npos), -np.ones(npos)])
    return _split(X, y, 20000, 200, rng)


def synthetic_c(seed=0) -> Arrays:
    """5-D normally distributed clusters, moderate overlap (~93%)."""
    rng = np.random.default_rng(seed)
    mu = np.array([0.9, 0.7, 0.5, 0.4, 0.3])
    X, y = _gauss_clusters(rng, 20200, 5, centers_pos=[mu], centers_neg=[-mu], scale=1.0)
    return _split(X, y, 20000, 200, rng)


def waveform(seed=0) -> Arrays:
    """Waveform-21 (Breiman et al.): classes 1 vs 2, 21 dims, 4000/1000."""
    rng = np.random.default_rng(seed)
    t = np.arange(1, 22, dtype=np.float64)

    def tri(center):
        return np.maximum(6.0 - np.abs(t - center), 0.0)

    h1, h2, h3 = tri(11), tri(7), tri(15)

    def gen(n, a, b):
        u = rng.uniform(size=(n, 1))
        return u * a + (1.0 - u) * b + rng.normal(size=(n, 21))

    n_tot = 5200
    X1 = gen(n_tot // 2, h1, h2)  # class 1
    X2 = gen(n_tot // 2, h1, h3)  # class 2
    X = np.concatenate([X1, X2])
    y = np.concatenate([np.ones(len(X1)), -np.ones(len(X2))])
    return _split(X, y, 4000, 1000, rng)


def _digit_prototypes(rng, easy: bool):
    """Two 28x28 stroke prototypes; easy=(0,1)-like, hard=(8,9)-like."""
    yy, xx = np.mgrid[0:28, 0:28]

    def ring(cy, cx, r, width):
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        return np.exp(-((d - r) ** 2) / (2.0 * width**2))

    def stroke(y0, y1, x0, x1, width=1.6):
        # line segment brush
        n = 64
        ys = np.linspace(y0, y1, n)[:, None, None]
        xs = np.linspace(x0, x1, n)[:, None, None]
        d2 = (yy[None] - ys) ** 2 + (xx[None] - xs) ** 2
        return np.exp(-d2 / (2.0 * width**2)).max(axis=0)

    if easy:
        p_a = ring(14, 14, 8, 1.8)  # "0"
        p_b = stroke(4, 24, 14, 14)  # "1"
    else:
        p_a = ring(9, 14, 5, 1.6) + ring(19, 14, 5, 1.6)  # "8"
        p_b = ring(9, 14, 5, 1.6) + stroke(13, 24, 18, 16)  # "9"
    return p_a, p_b


def _mnist_like(seed, easy, n_train, n_test) -> Arrays:
    rng = np.random.default_rng(seed)
    p_a, p_b = _digit_prototypes(rng, easy)
    n = n_train + n_test
    X = np.empty((n, 784), np.float32)
    y = np.empty(n, np.float32)
    for i in range(n):
        proto = p_a if i % 2 == 0 else p_b
        img = np.roll(proto, rng.integers(-2, 3), axis=0)
        img = np.roll(img, rng.integers(-2, 3), axis=1)
        img = img * rng.uniform(0.7, 1.3) + rng.normal(scale=0.25, size=(28, 28))
        X[i] = np.clip(img, 0, None).reshape(-1)
        y[i] = 1.0 if i % 2 == 0 else -1.0
    # normalize like MNIST pixels /255-ish scale
    X /= max(X.max(), 1e-6)
    return _split(X, y, n_train, n_test, rng)


def mnist01_like(seed=0) -> Arrays:
    return _mnist_like(seed, easy=True, n_train=12665, n_test=2115)


def mnist89_like(seed=0) -> Arrays:
    return _mnist_like(seed, easy=False, n_train=11800, n_test=1983)


def ijcnn_like(seed=0) -> Arrays:
    """22-dim, 35k/91701, ~10% positive, mostly non-linear boundary.

    Tuned so the linear-SVM ceiling sits just above the majority rate — the
    profile of the real IJCNN-2001 data (paper: libSVM 91.64 vs ~90.3
    majority; all single-pass methods below majority).
    """
    rng = np.random.default_rng(seed)
    n = 35000 + 91701
    X = rng.normal(size=(n, 22))
    score = 0.8 * (X[:, 0] + 0.5 * X[:, 4]) + (
        0.8 * X[:, 1] * X[:, 2] + 0.6 * np.sin(2.0 * X[:, 3]) + 0.5 * X[:, 5] * X[:, 6]
    )
    thresh = np.quantile(score, 0.90)  # ~10% positives
    y = np.where(score + 0.2 * rng.normal(size=n) > thresh, 1.0, -1.0)
    return _split(X.astype(np.float32), y, 35000, 91701, rng)


def w3a_like(seed=0) -> Arrays:
    """300-dim sparse binary, 44837/4912, ~3% positive (w3a profile)."""
    rng = np.random.default_rng(seed)
    n = 44837 + 4912
    density = 0.04
    X = (rng.uniform(size=(n, 300)) < density).astype(np.float32)
    w_true = rng.normal(size=300) * (rng.uniform(size=300) < 0.15)
    score = X @ w_true + 0.3 * rng.normal(size=n)
    thresh = np.quantile(score, 0.97)  # ~3% positives
    y = np.where(score > thresh, 1.0, -1.0)
    return _split(X, y, 44837, 4912, rng)


DATASETS: Dict[str, Callable[..., Arrays]] = {
    "synthetic_a": synthetic_a,
    "synthetic_b": synthetic_b,
    "synthetic_c": synthetic_c,
    "waveform": waveform,
    "mnist01": mnist01_like,
    "mnist89": mnist89_like,
    "ijcnn": ijcnn_like,
    "w3a": w3a_like,
}

# Paper Table 1 reference numbers (for EXPERIMENTS.md comparison columns).
PAPER_TABLE1 = {
    # dataset: (libSVM batch, Perceptron, Pegasos k=1, Pegasos k=20, LASVM,
    #           StreamSVM Algo1, StreamSVM Algo2)
    "synthetic_a": (96.5, 95.5, 83.8, 89.9, 96.5, 95.5, 97.0),
    "synthetic_b": (66.0, 68.0, 57.05, 65.85, 64.5, 64.4, 68.5),
    "synthetic_c": (93.2, 77.0, 55.0, 73.2, 68.0, 73.1, 87.5),
    "waveform": (89.4, 72.5, 77.34, 78.12, 77.6, 74.3, 78.4),
    "mnist01": (99.52, 99.47, 95.06, 99.48, 98.82, 99.34, 99.71),
    "mnist89": (96.57, 95.9, 69.41, 90.62, 90.32, 84.75, 94.7),
    "ijcnn": (91.64, 64.82, 67.35, 88.9, 74.27, 85.32, 87.81),
    "w3a": (98.29, 89.27, 57.36, 87.28, 96.95, 88.56, 89.06),
}


def load_dataset(name: str, seed: int = 0) -> Arrays:
    return DATASETS[name](seed=seed)
