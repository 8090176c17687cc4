"""StreamSVM's streaming driver and readouts for a bank of models.

fit_chunked_many(chunks, cs)  one pass of kernel B1 over an iterator of
                              chunks for a bank of B models (classes x
                              C-grid), with checkpoint hooks and resume.
decision_function / predict / accuracy   linear classifier readout.

The single-model entry points (``fit``, ``fit_ball``, ``fit_chunked``,
``fit_lookahead``) wait for kernels B4 and B3.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Tuple

import torch

from .._device import as_tensor, pick_device
from .meb import Ball


@dataclasses.dataclass
class StreamCheckpoint:
    ball: Ball
    position: int  # number of examples consumed


def fit_chunked_many(
    chunks: Iterable[Tuple[object, object]],
    cs,
    *,
    variant: str = "exact",
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
    rows (the one-vs-rest case). The checkpoint carries the whole bank, so
    a run resumes from ``resume`` without a second pass; ``checkpoint_cb``
    receives a StreamCheckpoint every ``checkpoint_every`` consumed rows.
    Numpy chunks go to ``device``; with ``device=None`` they go where the
    bank (``resume``, or the first chunk if it is a tensor) lives, else CUDA.
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
            Xc, yc, cs, bank, variant=variant, block_n=block_n, b_tile=b_tile,
            stream_dtype=stream_dtype, bank_resident=bank_resident,
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
