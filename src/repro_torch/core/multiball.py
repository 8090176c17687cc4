"""Multi-ball StreamSVM (the paper's Sec 4.3) and the bank of models.

``fit_multiball`` is the paper's general case: one model of L ball slots.
A row that no active ball encloses opens a free slot, or, with every slot
active, merges into the ball that grows least (B), or lets two balls merge
and opens the freed slot (C), whichever gives the smaller radius. The pass
is one launch of kernel M1 (``kernels.multiball``); an eager per-row loop
on the card would be bound by kernel launches. ``to_single_ball`` folds
the active balls into one (Algorithm 1's readout).

A *bank* is a stacked ``Ball`` with leading axis B, where every model
(classes x C-grid x variants) runs its own Algorithm 1 — kernel B1 — or,
with ``variant="lookahead"|"lookahead-paper"``, its own fused Algorithm 2
with a per-model L-row window — kernel B3; either kernel reads each stream
tile once for all B models (``kernels.ops.streamsvm_fit_many``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import as_tensor, pick_device
from .meb import Ball, fold_merge


class MultiBall(NamedTuple):
    """The L-slot state of ``fit_multiball``: w (L, D), r, xi2 (L,), m (L,)
    int32, active (L,) bool (an inactive slot holds zeros)."""

    w: torch.Tensor
    r: torch.Tensor
    xi2: torch.Tensor
    m: torch.Tensor
    active: torch.Tensor


def fit_multiball(X, y, c, n_balls: int = 4, variant: str = "exact", *,
                  device=None) -> MultiBall:
    """Single pass with L = ``n_balls`` ball slots through kernel M1. X:
    (N, D), y: (N,) +-1. Row 0 opens slot 0 (w = y0 x0, r = 0, xi2 the
    point's slack: 1/C for "exact", 1 for "paper-listing"); the other rows
    stream through M1 (on a CPU tensor, its plain version)."""
    from ..kernels.multiball import multiball_scan  # lazy: core <-> kernels cycle
    from ..kernels.ops import vmem_budget_bytes

    if variant not in ("exact", "paper-listing"):
        raise ValueError(f"unknown variant {variant!r}; expected 'exact' or 'paper-listing'")
    L = int(n_balls)
    if L < 1:
        raise ValueError(f"n_balls must be >= 1, got {n_balls}")
    dev = pick_device(device, X, y)
    X, y = as_tensor(X, dev, torch.float32).contiguous(), as_tensor(y, dev, torch.float32)
    n, d = X.shape
    if y.shape != (n,) or n < 1:
        raise ValueError(
            f"y must be (N,) labels matching X with N >= 1: got y.shape={tuple(y.shape)}, "
            f"X.shape={tuple(X.shape)}"
        )
    c_inv = torch.tensor(1.0 / c, dtype=torch.float32, device=dev)
    slack0 = c_inv if variant == "exact" else torch.ones_like(c_inv)
    w = torch.zeros((L, d), dtype=torch.float32, device=dev)
    w[0] = y[0] * X[0]
    r = torch.zeros((L,), dtype=torch.float32, device=dev)
    xi2 = torch.zeros((L,), dtype=torch.float32, device=dev)
    xi2[0] = slack0
    m = torch.zeros((L,), dtype=torch.int32, device=dev)
    m[0] = 1
    active = torch.zeros((L,), dtype=torch.bool, device=dev)
    active[0] = True
    multiball_scan(X[1:], y[1:].contiguous(), w, r, xi2, m, active, float(c_inv),
                   float(slack0), smem_budget=vmem_budget_bytes())
    return MultiBall(w=w, r=r, xi2=xi2, m=m, active=active)


def to_single_ball(mb: MultiBall) -> Ball:
    """Merge all active balls (inactive slots folded as zero-size copies of
    the first active ball, with m = 0)."""
    first = int(torch.argmax(mb.active.to(torch.int32)))
    rep = lambda a: torch.where(mb.active.reshape((-1,) + (1,) * (a.ndim - 1)), a, a[first])
    balls = Ball(w=rep(mb.w), r=rep(mb.r), xi2=rep(mb.xi2),
                 m=torch.where(mb.active, mb.m, torch.zeros_like(mb.m)))
    return fold_merge(balls)


def decision_function(mb: MultiBall, X, mode: str = "merged") -> torch.Tensor:
    """Margins of X: the merged ball's (mode "merged"), else the sum of the
    active balls' scores."""
    X = as_tensor(X, mb.w.device, mb.w.dtype)
    if mode == "merged":
        return X @ to_single_ball(mb).w
    scores = X @ mb.w.T  # (N, L)
    return torch.sum(torch.where(mb.active[None, :], scores, 0.0), -1)


def fit_bank(
    X,
    Y,
    cs,
    balls: Ball | None = None,
    *,
    variant: str = "exact",
    lookahead=None,
    block_n: int = 256,
    b_tile: int | None = None,
    stream_dtype=None,
    bank_resident: str = "auto",
    mesh=None,
    shard_axis="data",
    device=None,
) -> Ball:
    """One-pass fit of a bank of B models through kernel B1 (Algorithm 1)
    or B3 (the lookahead variants, Algorithm 2).

    X: (N, D) shared stream; Y: (B, N) per-model label signs; cs: scalar or
    (B,) per-model C. Continues from ``balls`` (stacked Ball) when given.
    See ``kernels.ops.streamsvm_fit_many`` for the other arguments.
    ``mesh=`` (a ``torch.distributed`` DeviceMesh) shards the stream over
    its ``shard_axis`` axes (``distributed.fit_bank_sharded``).
    """
    if mesh is not None:
        from .distributed import fit_bank_sharded  # lazy: module cycle

        return fit_bank_sharded(
            X, Y, cs, mesh, balls,
            axis=shard_axis, variant=variant, lookahead=lookahead, block_n=block_n,
            b_tile=b_tile, stream_dtype=stream_dtype, bank_resident=bank_resident,
            device=device,
        )
    from ..kernels.ops import streamsvm_fit_many  # lazy: core <-> kernels cycle

    return streamsvm_fit_many(
        X, Y, cs, balls,
        variant=variant, lookahead=lookahead, block_n=block_n, b_tile=b_tile,
        stream_dtype=stream_dtype, bank_resident=bank_resident, device=device,
    )


def bank_take(bank: Ball, i) -> Ball:
    """Model i of a stacked bank as a plain single Ball."""
    return Ball(*(x[i] for x in bank))


def bank_stack(balls) -> Ball:
    """Stack an iterable of single Balls into a bank (leading axis B)."""
    return Ball(*(torch.stack(leaves) for leaves in zip(*list(balls))))
