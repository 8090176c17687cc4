"""One-vs-rest multiclass StreamSVM and C-grid fitting.

Classes and C-grid points share the stream, so the default engine
(``engine="pallas"``) flattens them onto the bank axis of kernel B1 — or,
with ``lookahead > 1``, of the fused Algorithm-2 kernel B3: every stream
tile is read once and updates all B models. Within each C-grid group the
bank is class-major (model = g * n_classes + class). ``engine="scan"`` fits
one model at a time, through ``fit`` (kernel B4) or ``fit_lookahead(...,
engine="qp")``, as the reference vmaps them.
"""
from __future__ import annotations

import torch

from .._device import as_tensor, pick_device
from .meb import Ball
from .multiball import bank_stack, fit_bank
from .streamsvm import fit, fit_lookahead


def _cast_ball(ball: Ball, dtype) -> Ball:
    return Ball(w=ball.w.to(dtype), r=ball.r.to(dtype), xi2=ball.xi2.to(dtype), m=ball.m)


def _check_engine(engine: str, mesh) -> None:
    if engine not in ("pallas", "scan"):
        raise ValueError(f"unknown engine {engine!r}; expected 'pallas' or 'scan'")
    if mesh is not None and engine != "pallas":
        raise ValueError(f"mesh= requires engine='pallas': got engine={engine!r}")


def ovr_signs(labels, n_classes: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(N,) int labels -> (n_classes, N) one-vs-rest sign rows in {-1, +1}."""
    dev = pick_device(device, labels)
    labels = as_tensor(labels, dev)
    classes = torch.arange(n_classes, device=dev)
    return torch.where(labels[None, :] == classes[:, None], 1.0, -1.0).to(dtype)


def fit_ovr(
    X,
    labels,
    n_classes: int,
    c,
    *,
    lookahead: int = 1,
    variant: str = "exact",
    engine: str = "pallas",
    b_tile: int | None = None,
    stream_dtype=None,
    bank_resident: str = "auto",
    mesh=None,
    shard_axis="data",
    device=None,
) -> Ball:
    """labels: (N,) int in [0, n_classes). Returns a Ball stacked over
    classes. The pallas engine trains them all in one stream pass of kernel
    B1, or of B3 when ``lookahead > 1``; the scan engine fits one class at a
    time (Algorithm 1 through ``fit``, Algorithm 2 through the qp engine).
    """
    _check_engine(engine, mesh)
    if variant not in ("exact", "paper-listing"):
        raise ValueError(f"unknown variant {variant!r}; expected 'exact' or 'paper-listing'")
    dev = pick_device(device, X, labels)
    X = as_tensor(X, dev)
    ys = ovr_signs(labels, n_classes, X.dtype, device=dev)
    if engine == "scan":
        if lookahead <= 1:
            return bank_stack(fit(X, yv, c, variant=variant) for yv in ys)
        return bank_stack(
            fit_lookahead(X, yv, c, lookahead, variant=variant, engine="qp") for yv in ys
        )
    la = None
    if lookahead > 1:  # Algorithm 2 with the variant's slack gain
        variant = "lookahead" if variant == "exact" else "lookahead-paper"
        la = int(lookahead)
    bank = fit_bank(
        X, ys, c, variant=variant, lookahead=la, b_tile=b_tile, stream_dtype=stream_dtype,
        bank_resident=bank_resident, mesh=mesh, shard_axis=shard_axis,
    )
    return _cast_ball(bank, X.dtype)


def fit_c_grid(
    X,
    y,
    c_grid,
    *,
    variant: str = "exact",
    engine: str = "pallas",
    b_tile: int | None = None,
    stream_dtype=None,
    bank_resident: str = "auto",
    mesh=None,
    shard_axis="data",
    device=None,
) -> Ball:
    """A sweep over a grid of C values in ONE stream pass: every grid point
    is a model of the bank. Returns a Ball stacked over the grid. The scan
    engine fits one grid point at a time through ``fit``."""
    _check_engine(engine, mesh)
    dev = pick_device(device, X, y)
    X, y = as_tensor(X, dev), as_tensor(y, dev)
    c_grid = as_tensor(c_grid, dev, torch.float32).reshape(-1)
    if engine == "scan":
        return bank_stack(fit(X, y, cv, variant=variant) for cv in c_grid)
    Y = y[None, :].expand(c_grid.shape[0], y.shape[0]).to(X.dtype)
    bank = fit_bank(
        X, Y, c_grid, variant=variant, b_tile=b_tile, stream_dtype=stream_dtype,
        bank_resident=bank_resident, mesh=mesh, shard_axis=shard_axis,
    )
    return _cast_ball(bank, X.dtype)


def predict_ovr(balls: Ball, X) -> torch.Tensor:
    """Direct OVR readout: argmax margin over the bank's model axis."""
    X = as_tensor(X, balls.w.device, balls.w.dtype)
    return torch.argmax(X @ balls.w.T, dim=-1)


def predict_c_grid(balls: Ball, X, n_classes: int):
    """Per-C-grid-group OVR readout of a (G * n_classes)-model bank.

    Returns ``((N, G) int32 predicted class, (N, G) f32 margin)``. Direct
    path; the fused serving twin is ``kernels.ops.predict_bank(...,
    epilogue="ovr")``.
    """
    X = as_tensor(X, balls.w.device, balls.w.dtype)
    scores = X @ balls.w.T
    b = scores.shape[1]
    if n_classes < 1 or b % n_classes:
        raise ValueError(
            f"n_classes must be >= 1 and divide the bank size: got "
            f"n_classes={n_classes}, B={b}"
        )
    grouped = scores.reshape(X.shape[0], b // n_classes, n_classes)
    return torch.argmax(grouped, dim=-1).to(torch.int32), grouped.amax(dim=-1)
