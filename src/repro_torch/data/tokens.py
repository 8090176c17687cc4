"""Synthetic LM token pipeline: Zipf-Markov streams + two-"style" corpora.

The port's numpy-only copy of the reference's ``data/tokens.py``: the same
numpy calls, so the same seed gives the same arrays bit for bit. The repo
works offline, so its LM examples run on synthetic token streams with
enough structure for the loss to fall fast (first-order Markov chains with
Zipfian marginals). `styled_corpus` yields
two latent styles (different transition matrices) for the feature->StreamSVM
classification example.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def _markov(rng, vocab: int, branch: int = 20, temp: float = 1.0, lo=0, hi=None):
    """Sparse per-token transition table: (vocab, branch) targets + probs.

    Targets are confined to [lo, hi) so corpora can occupy distinct vocab
    regions (distinguishable styles)."""
    hi = vocab if hi is None else hi
    targets = rng.integers(lo, hi, size=(vocab, branch))
    raw = rng.exponential(scale=temp, size=(vocab, branch))
    probs = raw / raw.sum(axis=1, keepdims=True)
    return targets, probs


def _sample(rng, targets, probs, n: int, start: int = 0) -> np.ndarray:
    out = np.empty(n, np.int32)
    t = start
    for i in range(n):
        j = rng.choice(probs.shape[1], p=probs[t])
        t = int(targets[t, j])
        out[i] = t
    return out


def token_batches(
    vocab: int, batch: int, seq: int, steps: int, seed: int = 0
) -> Iterator[dict]:
    """Yields {tokens, targets} int32 (batch, seq) — targets are shifted."""
    rng = np.random.default_rng(seed)
    targets_tab, probs = _markov(rng, vocab)
    for _ in range(steps):
        toks = np.stack(
            [_sample(rng, targets_tab, probs, seq + 1, start=int(rng.integers(vocab)))
             for _ in range(batch)]
        )
        yield {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def styled_corpus(
    vocab: int, n_docs: int, seq: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens (n_docs, seq), labels ±1) — two Markov 'styles'."""
    rng = np.random.default_rng(seed)
    # two styles: mostly-disjoint vocab regions + branching factors
    tabs = [
        _markov(rng, vocab, branch=4, temp=0.7, lo=0, hi=int(0.55 * vocab)),
        _markov(rng, vocab, branch=50, temp=2.5, lo=int(0.45 * vocab), hi=vocab),
    ]
    starts = [rng.integers(0, vocab // 2, 64), rng.integers(vocab // 2, vocab, 64)]
    toks = np.empty((n_docs, seq), np.int32)
    labels = np.empty(n_docs, np.float32)
    for i in range(n_docs):
        s = i % 2
        t, p = tabs[s]
        toks[i] = _sample(rng, t, p, seq, start=int(rng.choice(starts[s])))
        labels[i] = 1.0 if s == 0 else -1.0
    return toks, labels
