"""The bank of models: B independent fits over one stream.

A *bank* is a stacked ``Ball`` with leading axis B, where every model
(classes x C-grid x variants) runs its own Algorithm 1 — kernel B1 — or,
with ``variant="lookahead"|"lookahead-paper"``, its own fused Algorithm 2
with a per-model L-row window — kernel B3; either kernel reads each stream
tile once for all B models (``kernels.ops.streamsvm_fit_many``). The
paper's Sec 4.3 multi-ball classifier (``fit_multiball``) is not ported
yet.
"""
from __future__ import annotations

import torch

from .meb import Ball


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
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (the stream sharded across devices) is not ported yet: "
            "ROADMAP A10"
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
