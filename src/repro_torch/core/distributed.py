"""Distributed one-pass StreamSVM on ``torch.distributed``.

The stream is split into contiguous ranges over the named axes of a
``torch.distributed.device_mesh.DeviceMesh``; every rank holds the whole
stream, fits its own range on its own device through the port's engines
(one pass, O(D) state a model), and the ranks exchange their states with
one all_gather over the mesh's group (one per named axis). Every rank then
folds the same stack, in the same order, with the paper's Sec-4.3 merge
(``meb.fold_merge``, or ``meb.fold_kernel_banks`` for kernelized banks),
outside any compiled region, so every rank holds the same bits and they are
the bits of the per-range single-process fits folded in order.

``fit_sharded``             one model, Algorithm 1 / 2 per range.
``fit_bank_sharded``        a bank of B models per range (B1 / B3 / B6).
``fit_kernel_bank_sharded`` the kernelized bank per range (B5 + R1).
``fit_kernel_bank_shards``  the same per-range fits, gathered, not folded.

Ragged N: the rows per shard are ``ceil(N / n_shards)``, the last live
range is padded with inert rows (feature 0, sign 0) and ranges past the data
are dead: they fit nothing and the fold skips them (``shard_ranges``).

Communication: one all_gather of B (D + 3) floats a shard (a kernel bank:
B S (D + 2) + 4 B), once per stream. With the gloo backend the states go
through host copies and the folded result comes back to the fit's device.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .._device import as_tensor, pick_device
from .kernel_bank import KernelBank, _fit_kernel_bank
from .meb import Ball, fold_kernel_banks, fold_merge, merge_banks
from .streamsvm import fit, fit_lookahead


def shard_ranges(n: int, n_shards: int) -> list[Tuple[int, int]]:
    """The canonical ceil-split of ``n`` stream rows into ``n_shards``
    contiguous ``[lo, hi)`` ranges: rows per shard ``ceil(n / n_shards)``,
    trailing shards past the data empty ``(n, n)``. The sharded fits assign
    exactly these ranges, so per-range single-device fits fold to their
    bits."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1: got {n_shards}")
    if n < 0:
        raise ValueError(f"n must be >= 0: got {n}")
    shard_n = -(-n // n_shards) if n else 0
    return [(min(j * shard_n, n), min((j + 1) * shard_n, n)) for j in range(n_shards)]


def _mesh_groups(mesh, axis) -> tuple[list, int, int]:
    """The process groups of the named mesh axes, this rank's shard index
    (row-major over the axes, by group rank) and the shard count."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            "mesh must be a torch.distributed.device_mesh.DeviceMesh: got "
            f"{type(mesh).__name__}"
        )
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    names = mesh.mesh_dim_names or ()
    missing = [a for a in axes if a not in names]
    if missing or not axes:
        raise ValueError(f"mesh axes {axes} are not all among the mesh's dim names {names}")
    groups = [mesh.get_group(a) for a in axes]
    sid, count = 0, 1
    for a, g in zip(axes, groups):
        size = mesh.size(names.index(a))
        sid = sid * size + torch.distributed.get_rank(g)
        count *= size
    return groups, sid, count


def _gather(leaves, groups, count: int) -> list[torch.Tensor]:
    """Every shard's ``leaves``, stacked on a new leading (count,) axis in
    shard order: one all_gather a mesh axis of all leaves packed into one
    float32 buffer (int32 leaves by their bits). Through host copies on
    gloo; the stack lands on the leaves' device."""
    dev = leaves[0].device
    flat = [v.reshape(-1) for v in leaves]
    buf = torch.cat([v.view(torch.float32) if v.dtype == torch.int32 else v.float() for v in flat])
    for g in reversed(groups):
        on_host = torch.distributed.get_backend(g) == "gloo"
        src = buf.cpu() if on_host else buf
        out = [torch.empty_like(src) for _ in range(torch.distributed.get_world_size(g))]
        torch.distributed.all_gather(out, src, group=g)
        buf = torch.stack(out).to(dev)  # (size, *previous)
    buf = buf.reshape(count, -1)
    stacked, at = [], 0
    for v in leaves:
        part = buf[:, at : at + v.numel()]
        at += v.numel()
        if v.dtype == torch.int32:
            part = part.contiguous().view(torch.int32)
        stacked.append(part.reshape((count,) + tuple(v.shape)).to(v.dtype))
    return stacked


def _shard_rows(X, Y, sid: int, count: int):
    """This shard's rows (X, and Y's columns when given), padded to
    ``ceil(N / count)`` rows with inert rows; None past the data."""
    n = X.shape[0]
    shard_n = -(-n // count)
    lo, hi = shard_ranges(n, count)[sid]
    if lo >= hi:
        return None
    pad = shard_n - (hi - lo)
    Xs = F.pad(X[lo:hi], (0, 0, 0, pad))
    Ys = None if Y is None else F.pad(Y[..., lo:hi], (0, pad))
    return Xs, Ys, lo


def fit_sharded(X, y, c, mesh, *, axis="data", lookahead: int = 1, variant: str = "exact",
                device=None) -> Ball:
    """One-pass fit with the stream sharded over ``axis`` of ``mesh``.

    X: (N, D), y: (N,); N must divide by the shard count
    (``fit_bank_sharded`` pads ragged remainders). Each rank fits its range
    with ``fit`` (Algorithm 1, kernel B4) or ``fit_lookahead`` (Algorithm 2,
    kernel B3); returns the folded Ball, the same on every rank.
    """
    groups, sid, count = _mesh_groups(mesh, axis)
    dev = pick_device(device, X, y)
    X, y = as_tensor(X, dev, torch.float32), as_tensor(y, dev, torch.float32)
    if X.shape[0] % count != 0:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        raise ValueError(
            f"X rows must divide evenly over the {count} stream shards of "
            f"mesh axes {axes}: got X.shape={tuple(X.shape)}. Pad the stream, or "
            "use fit_bank_sharded, which pads ragged remainders with inert "
            "sign-0 rows."
        )
    lo, hi = shard_ranges(X.shape[0], count)[sid]
    if lookahead <= 1:
        ball = fit(X[lo:hi], y[lo:hi], c, variant=variant)
    else:
        ball = fit_lookahead(X[lo:hi], y[lo:hi], c, lookahead, variant=variant)
    return fold_merge(Ball(*_gather(list(ball), groups, count)))


def _live(n: int, count: int) -> list[bool]:
    return [lo < hi for lo, hi in shard_ranges(n, count)]


def fit_bank_sharded(X, Y, cs, mesh, balls: Ball | None = None, *, axis="data",
                     variant: str = "exact", lookahead=None, block_n: int = 256,
                     b_tile: int | None = None, stream_dtype=None, bank_resident: str = "auto",
                     device=None) -> Ball:
    """M stream shards x B models in one pass: the sharded bank engine.

    Each rank runs ``fit_bank`` (``b_tile``, ``lookahead``, ``stream_dtype``
    and ``bank_resident`` apply per shard) fresh over its range, the (B, D)
    banks are gathered, and every model is folded with the Sec-4.3 merge
    (``meb.fold_merge`` with dead shards masked out). X: (N, D), Y: (B, N)
    per-model sign rows, cs: scalar or (B,). Any N works (inert padding).
    ``balls`` continues a previous fit: it saw an earlier, disjoint part of
    the stream, so it is folded in last, like one more shard, which makes a
    resume independent of the shard count. Returns the folded bank, the same
    on every rank.
    """
    from .multiball import fit_bank

    groups, sid, count = _mesh_groups(mesh, axis)
    dev = pick_device(device, X, Y)
    X, Y = as_tensor(X, dev), as_tensor(Y, dev)
    n, d = X.shape
    b = Y.shape[0]
    if Y.shape != (b, n):
        raise ValueError(
            f"Y must be (B, N) sign rows matching X: got Y.shape={tuple(Y.shape)}, "
            f"X.shape={tuple(X.shape)}"
        )
    if n < 1:
        raise ValueError(f"need at least one stream row: got X.shape={tuple(X.shape)}")
    cs = as_tensor(cs, dev, torch.float32).broadcast_to((b,))
    part = _shard_rows(X, Y, sid, count)
    if part is None:  # a dead shard: a placeholder the fold skips
        bank = Ball(w=torch.zeros((b, d), dtype=torch.float32, device=dev),
                    r=torch.zeros((b,), dtype=torch.float32, device=dev),
                    xi2=torch.zeros((b,), dtype=torch.float32, device=dev),
                    m=torch.zeros((b,), dtype=torch.int32, device=dev))
    else:
        bank = fit_bank(part[0], part[1], cs, variant=variant, lookahead=lookahead,
                        block_n=block_n, b_tile=b_tile, stream_dtype=stream_dtype,
                        bank_resident=bank_resident)
    folded = fold_merge(Ball(*_gather(list(bank), groups, count)), live=_live(n, count))
    if balls is not None:
        prior = Ball(
            w=as_tensor(balls.w, dev, torch.float32),
            r=as_tensor(balls.r, dev, torch.float32).broadcast_to((b,)),
            xi2=as_tensor(balls.xi2, dev, torch.float32).broadcast_to((b,)),
            m=as_tensor(balls.m, dev, torch.int32).broadcast_to((b,)),
        )
        folded = merge_banks(prior, folded)
    return folded


def _kernel_shard(X, Y, cs, gamma, sid, count, *, kernel, coreset_size, eviction, variant,
                  block_n, s_tile, stream_dtype, dev) -> KernelBank:
    """This rank's kernelized fit of its range, ``idx`` in global stream
    coordinates; an empty (m == 0) bank for a dead shard."""
    X, Y = as_tensor(X, dev, torch.float32), as_tensor(Y, dev, torch.float32)
    n, d = X.shape
    b = Y.shape[0]
    if Y.shape != (b, n):
        raise ValueError(
            f"Y must be (B, N) sign rows matching X: got Y.shape={tuple(Y.shape)}, "
            f"X.shape={tuple(X.shape)}"
        )
    if n < 1:
        raise ValueError(f"need at least one stream row: got X.shape={tuple(X.shape)}")
    part = _shard_rows(X, Y, sid, count)
    s_size = int(coreset_size)
    if part is None:
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
        return KernelBank(idx=torch.full((b, s_size), -1, dtype=torch.int32, device=dev),
                          coef=zeros(b, s_size), points=zeros(b, s_size, d), q=zeros(b),
                          r=zeros(b), xi2=zeros(b), m=torch.zeros((b,), dtype=torch.int32,
                                                                  device=dev))
    Xs, Ys, lo = part
    bank = _fit_kernel_bank(Xs, Ys, cs, gamma, kernel=kernel, coreset_size=s_size,
                            eviction=eviction, variant=variant, block_n=block_n, s_tile=s_tile,
                            stream_dtype=stream_dtype, device=dev)
    return bank._replace(idx=torch.where(bank.idx >= 0, bank.idx + lo, bank.idx))


def fit_kernel_bank_shards(X, Y, cs, mesh, *, axis="data", kernel: str = "rbf", gamma=1.0,
                           coreset_size: int = 64, eviction: str = "smallest-coef",
                           variant: str = "exact", block_n: int = 256,
                           s_tile: int | None = None, stream_dtype=None,
                           device=None) -> KernelBank:
    """Per-shard kernelized fits on the mesh, gathered and NOT folded: every
    KernelBank leaf grows a leading (n_shards,) axis, the same on every rank,
    with ``idx`` in global stream coordinates; shards past the data come
    back as empty (m == 0) banks. The caller folds them
    (``meb.fold_kernel_banks``), typically skipping the empty ranges of
    ``shard_ranges``."""
    groups, sid, count = _mesh_groups(mesh, axis)
    dev = pick_device(device, X, Y)
    bank = _kernel_shard(X, Y, cs, gamma, sid, count, kernel=kernel,
                         coreset_size=coreset_size, eviction=eviction, variant=variant,
                         block_n=block_n, s_tile=s_tile, stream_dtype=stream_dtype, dev=dev)
    return KernelBank(*_gather(list(bank), groups, count))


def fit_kernel_bank_sharded(X, Y, cs, mesh, *, axis="data", kernel: str = "rbf", gamma=1.0,
                            coreset_size: int = 64, eviction: str = "smallest-coef",
                            variant: str = "exact", block_n: int = 256,
                            s_tile: int | None = None, stream_dtype=None,
                            device=None) -> KernelBank:
    """M stream shards x B kernelized models in one pass each: per-range
    fits (``fit_kernel_bank_shards``), folded in shard order over the live
    shards with the kernelized Sec-4.3 merge (``meb.fold_kernel_banks``:
    cross-Gram center distance, coreset-of-coresets back to S slots). The
    folded bank's ``idx`` is in global stream coordinates. Returns the same
    bank on every rank."""
    stacked = fit_kernel_bank_shards(
        X, Y, cs, mesh, axis=axis, kernel=kernel, gamma=gamma, coreset_size=coreset_size,
        eviction=eviction, variant=variant, block_n=block_n, s_tile=s_tile,
        stream_dtype=stream_dtype, device=device,
    )
    n_shards = stacked.coef.shape[0]
    return fold_kernel_banks(stacked, kernel=kernel, gamma=gamma, eviction=eviction,
                             live=_live(int(X.shape[0]), n_shards))
