"""Streaming utilities: permutations, chunk iterators, contiguous shard ranges.

The port's own copy of ``repro/data/stream.py`` (numpy only).

The shard-range contract matters for fault tolerance: work is assigned as
contiguous [start, end) ranges so a failed/straggling shard's range can be
re-issued to survivors, and the ball merge is order-insensitive (the
reference's core/distributed.py and runtime/fault_tolerance.py).
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np


def permuted(X, y, seed: int):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(y))
    return X[idx], y[idx]


def chunk_stream(X, y, chunk_size: int = 4096, start: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (X_chunk, y_chunk) from `start` — supports checkpoint resume."""
    n = len(y)
    for lo in range(start, n, chunk_size):
        hi = min(lo + chunk_size, n)
        yield X[lo:hi], y[lo:hi]


def shard_ranges(n: int, n_shards: int) -> List[Tuple[int, int]]:
    """Contiguous near-equal [start, end) ranges covering [0, n)."""
    base, rem = divmod(n, n_shards)
    out, lo = [], 0
    for s in range(n_shards):
        hi = lo + base + (1 if s < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out
