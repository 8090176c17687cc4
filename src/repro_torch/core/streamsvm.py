"""StreamSVM — one-pass l2-SVM via streaming MEB (paper Algorithms 1 & 2).

Entry points
------------
fit(X, y, c)                    Algorithm 1 for one model, through kernel B4.
fit_lookahead(X, y, c, L)       Algorithm 2: the fused kernel B3 (engine
                                "pallas") or the window solve of qp.py
                                (engine "qp").
fit_chunked(...)                streaming driver over an iterator of chunks,
                                with checkpoint hooks and resume.
fit_chunked_many(...)           the same driver for a bank of B models
                                (classes x C-grid x variants) through B1/B3.
decision_function / predict     linear classifier readout.

The ball algebra lives in meb.py / qp.py; this module is the streaming
control flow. Where the reference scans row by row in ``lax.scan``
(``fit_ball``), the port runs the whole stream in one kernel launch: an
eager per-row loop on the card would be bound by kernel launches.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Tuple

import torch

from .._device import as_tensor, pick_device
from .meb import Ball, make_ball, point_distance
from .qp import solve_meb_ball_points

#: Rows whose distances the qp engine computes against the current ball in
#: one call; the ball does not change between flushes, so the decisions are
#: the reference's row-by-row ones.
_QP_SEGMENT = 1024


def _check_variant(variant: str) -> None:
    if variant not in ("exact", "paper-listing"):
        raise ValueError(f"unknown variant {variant!r}; expected 'exact' or 'paper-listing'")


def init_ball(x1, y1, c, *, variant: str = "exact") -> Ball:
    """Paper line 3: w = y1 x1, R = 0, xi2 = 1/C (exact) or 1 (paper-listing)."""
    _check_variant(variant)
    xi2 = (1.0 / c) if variant == "exact" else 1.0
    return make_ball(y1 * x1, r=0.0, xi2=xi2, m=1)


def fit_ball(ball: Ball, X, y, c, *, variant: str = "exact", device=None) -> Ball:
    """Continue Algorithm 1 from an existing ball over (X, y), through B4.

    As in the reference every row is the point ``y x`` (a row with y = 0 is
    the zero point, not an inert row). ``variant``: "exact" (slack gain
    1/C) or "paper-listing" (gain 1).
    """
    from ..kernels.ops import fit_single  # lazy: core <-> kernels cycle

    _check_variant(variant)
    dev = pick_device(device, X, y, ball.w)
    X, y = as_tensor(X, dev, torch.float32), as_tensor(y, dev, torch.float32)
    c_inv = torch.as_tensor(1.0 / c, dtype=torch.float32, device=dev)
    gain = c_inv if variant == "exact" else torch.ones_like(c_inv)
    return fit_single(y[:, None] * X, torch.ones_like(y), ball, c_inv, gain)


def fit(X, y, c, *, variant: str = "exact", device=None) -> Ball:
    """Algorithm 1 over a full (in-memory) stream. X: (N, D), y: (N,) in ±1."""
    dev = pick_device(device, X, y)
    X, y = as_tensor(X, dev, torch.float32), as_tensor(y, dev, torch.float32)
    ball = init_ball(X[0], y[0], c, variant=variant)
    return fit_ball(ball, X[1:], y[1:], c, variant=variant)


# ---------------------------------------------------------------------------
# Algorithm 2 — lookahead
# ---------------------------------------------------------------------------


def fit_lookahead_ball(ball: Ball, X, y, c, lookahead: int, *, qp_iters: int = 128,
                       device=None) -> Ball:
    """Continue Algorithm 2 from an existing ball: buffer the rows that lie
    on or outside the ball (``d >= r``); when L are buffered, replace the
    ball by the smallest ball enclosing it and them (``qp.py``); solve the
    partial window after the last row.

    The ball does not change between flushes, so the distances of a run of
    rows are computed in one call and the L-th violator found by counting:
    the decisions of the reference's row-by-row scan, a few launches per
    flush instead of a few per row.
    """
    L = int(lookahead)
    if L < 1:
        raise ValueError(f"lookahead must be >= 1, got {L}")
    dev = pick_device(device, X, y, ball.w)
    X, y = as_tensor(X, dev, torch.float32), as_tensor(y, dev, torch.float32)
    c_inv = torch.as_tensor(1.0 / c, dtype=torch.float32, device=dev)
    yx = y[:, None] * X
    n, d = yx.shape
    window = []  # buffered rows, in order
    pos = 0
    while pos < n:
        seg = yx[pos : pos + _QP_SEGMENT]
        take = (point_distance(ball, seg, c_inv) >= ball.r).nonzero()[:, 0]
        need = L - sum(len(p) for p in window)
        if len(take) < need:
            window.append(seg[take])
            pos += len(seg)
            continue
        window.append(seg[take[:need]])
        valid = torch.ones((L,), dtype=torch.bool, device=dev)
        ball = solve_meb_ball_points(ball, torch.cat(window), valid, c_inv, iters=qp_iters)
        window = []
        pos += int(take[need - 1]) + 1
    # Final partial flush (paper lines 12-14), over the zero-padded window.
    pts = torch.zeros((L, d), dtype=yx.dtype, device=dev)
    rows = torch.cat(window) if window else pts[:0]
    pts[: len(rows)] = rows
    valid = torch.arange(L, device=dev) < len(rows)
    return solve_meb_ball_points(ball, pts, valid, c_inv, iters=qp_iters)


def fit_lookahead(
    X,
    y,
    c,
    lookahead: int,
    *,
    qp_iters: int = 128,
    variant: str = "exact",
    engine: str = "pallas",
    block_n: int = 256,
    stream_dtype=None,
    bank_resident: str = "auto",
    device=None,
) -> Ball:
    """Algorithm 2. lookahead=1 is Algorithm 1 (exactly, for engine="pallas").

    engine="pallas" (default) runs the fused kernel B3 on a bank of one
    model: the L-row window is flushed farthest-point-first inside the
    kernel (greedy Badoiu-Clarkson insertion over the window), so Algorithm
    2 costs the same single stream read as Algorithm 1. engine="qp" solves
    each full window with the iterative BC solver of qp.py (also what
    ``fit_chunked`` uses). The two accept slightly different core-vector
    sets; both keep the paper's enclosure guarantee.
    """
    if engine not in ("pallas", "qp"):
        raise ValueError(f"unknown engine {engine!r}; expected 'pallas' or 'qp'")
    _check_variant(variant)
    dev = pick_device(device, X, y)
    X, y = as_tensor(X, dev, torch.float32), as_tensor(y, dev, torch.float32)
    if engine == "pallas":
        from .multiball import fit_bank

        bank = fit_bank(
            X, y[None, :], c,
            variant="lookahead" if variant == "exact" else "lookahead-paper",
            lookahead=int(lookahead), block_n=block_n, stream_dtype=stream_dtype,
            bank_resident=bank_resident,
        )
        return Ball(*(v[0] for v in bank))
    ball = init_ball(X[0], y[0], c, variant=variant)
    return fit_lookahead_ball(ball, X[1:], y[1:], c, lookahead, qp_iters=qp_iters)


# ---------------------------------------------------------------------------
# Streaming drivers (one pass over an iterator, constant memory)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StreamCheckpoint:
    ball: Ball
    position: int  # number of examples consumed


def fit_chunked(
    chunks: Iterable[Tuple[object, object]],
    c,
    *,
    lookahead: int = 1,
    variant: str = "exact",
    qp_iters: int = 128,
    resume: Optional[StreamCheckpoint] = None,
    checkpoint_every: int = 0,
    checkpoint_cb: Optional[Callable[[StreamCheckpoint], None]] = None,
    device=None,
) -> StreamCheckpoint:
    """One pass over an iterator of (X_chunk, y_chunk) with O(D) state.

    Each chunk continues Algorithm 1 (``fit_ball``, kernel B4) or, with
    ``lookahead > 1``, Algorithm 2 (``fit_lookahead_ball``, the qp engine).
    ``checkpoint_cb`` receives a StreamCheckpoint every ``checkpoint_every``
    consumed examples, so a run resumes at ``.position`` without a second
    pass. With lookahead > 1 the window is flushed at every chunk boundary,
    which keeps the resume state O(D). Numpy chunks go to ``device``; with
    ``device=None`` they go where the ball (``resume``, or the first chunk
    if it is a tensor) lives, else CUDA.
    """
    ball = resume.ball if resume is not None else None
    pos = resume.position if resume is not None else 0
    since_ckpt = 0

    for Xc, yc in chunks:
        dev = pick_device(device, None if ball is None else ball.w, Xc)
        Xc, yc = as_tensor(Xc, dev, torch.float32), as_tensor(yc, dev, torch.float32)
        n_chunk = int(Xc.shape[0])
        if ball is None:
            ball = init_ball(Xc[0], yc[0], c, variant=variant)
            Xc, yc = Xc[1:], yc[1:]
        if Xc.shape[0]:
            if lookahead <= 1:
                ball = fit_ball(ball, Xc, yc, c, variant=variant)
            else:
                ball = fit_lookahead_ball(ball, Xc, yc, c, lookahead, qp_iters=qp_iters)
        pos += n_chunk
        since_ckpt += n_chunk
        if checkpoint_every and checkpoint_cb and since_ckpt >= checkpoint_every:
            checkpoint_cb(StreamCheckpoint(ball=ball, position=pos))
            since_ckpt = 0
    if ball is None:
        raise ValueError(
            "fit_chunked got an empty stream: the chunk iterator yielded no "
            f"examples (resume={resume!r}) — at least one (X, y) chunk with "
            "one row is required to initialize the ball"
        )
    return StreamCheckpoint(ball=ball, position=pos)


def fit_chunked_many(
    chunks: Iterable[Tuple[object, object]],
    cs,
    *,
    variant: str = "exact",
    lookahead=None,
    block_n: int = 256,
    b_tile: Optional[int] = None,
    stream_dtype=None,
    bank_resident: str = "auto",
    mesh=None,
    shard_axis="data",
    resume: Optional[StreamCheckpoint] = None,
    checkpoint_every: int = 0,
    checkpoint_cb: Optional[Callable[[StreamCheckpoint], None]] = None,
    device=None,
) -> StreamCheckpoint:
    """One pass of the bank engine over an iterator of chunks.

    ``cs`` is a (B,) array of per-model C values; each chunk is
    ``(X_chunk, y_chunk)`` with ``y_chunk`` either (n,) shared +-1 labels
    (broadcast to every model, the C-grid case) or (B, n) per-model sign
    rows (the one-vs-rest case). ``variant`` and ``lookahead`` are those of
    ``kernels.ops.streamsvm_fit_many``: the lookahead variants run B3 and
    flush their windows at every chunk boundary. The checkpoint carries the
    whole bank, so a run resumes from ``resume`` without a second pass;
    ``checkpoint_cb`` receives a StreamCheckpoint every ``checkpoint_every``
    consumed rows. Numpy chunks go to ``device``; with ``device=None`` they
    go where the bank (``resume``, or the first chunk if it is a tensor)
    lives, else CUDA.
    """
    from .multiball import fit_bank

    n_models = int(torch.as_tensor(cs).reshape(-1).shape[0])
    bank = resume.ball if resume is not None else None
    pos = resume.position if resume is not None else 0
    since_ckpt = 0

    for Xc, yc in chunks:
        dev = pick_device(device, None if bank is None else bank.w, Xc)
        Xc, yc = as_tensor(Xc, dev), as_tensor(yc, dev)
        if yc.ndim == 1:
            yc = yc[None, :].expand(n_models, yc.shape[0])
        n_chunk = int(Xc.shape[0])
        bank = fit_bank(
            Xc, yc, cs, bank, variant=variant, lookahead=lookahead, block_n=block_n,
            b_tile=b_tile, stream_dtype=stream_dtype, bank_resident=bank_resident,
            mesh=mesh, shard_axis=shard_axis,
        )
        pos += n_chunk
        since_ckpt += n_chunk
        if checkpoint_every and checkpoint_cb and since_ckpt >= checkpoint_every:
            checkpoint_cb(StreamCheckpoint(ball=bank, position=pos))
            since_ckpt = 0
    if bank is None:
        raise ValueError(
            "fit_chunked_many got an empty stream: the chunk iterator "
            f"yielded no examples for the {n_models}-model bank "
            f"(resume={resume!r}) — at least one (X, Y) chunk with one row "
            "is required to initialize the bank"
        )
    return StreamCheckpoint(ball=bank, position=pos)


def decision_function(ball: Ball, X) -> torch.Tensor:
    return as_tensor(X, ball.w.device, ball.w.dtype) @ ball.w


def predict(ball: Ball, X) -> torch.Tensor:
    return torch.sign(decision_function(ball, X))


def accuracy(ball: Ball, X, y) -> torch.Tensor:
    y = as_tensor(y, ball.w.device)
    return ((decision_function(ball, X) * y) > 0).float().mean()
