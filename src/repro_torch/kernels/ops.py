"""Public wrappers around the port's kernels: padding, tiling, dtype policy.

These are the entry points the rest of the port uses. They keep the JAX
package's padding, seeding and state packing (``repro/kernels/ops.py``), so
the two agree model for model; the 128-lane padding of D is a TPU tiling
rule and is not kept. Each runs on the device its inputs name (see
``repro_torch._device``): B1 and B2 launch on a CUDA tensor and run their
plain versions on a CPU tensor.

Dtype policy
------------
``stream_dtype`` is the precision of the *streamed* tiles: the (N, D) data
and (B, N) signs of a fit, the (Q, D) queries of a predict. ``"bf16"`` halves
those bytes. The bank, the ball scalars and every accumulator stay f32.

Bank residency
--------------
On the card the bank always lives in device memory, so ``"vmem"`` and
``"auto"`` both run B1/B2 as they are. ``"hbm"``, the TPU's ring through
VMEM, is the B6 kernel, not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .._device import as_tensor, pick_device
from ..core.meb import Ball
from .predict import NEG_MASK, predict_bank_fused
from .streamsvm_scan import streamsvm_scan_many

_STREAM_DTYPES = {
    None: torch.float32,
    "f32": torch.float32,
    "float32": torch.float32,
    torch.float32: torch.float32,
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    torch.bfloat16: torch.bfloat16,
}


def _resolve_stream_dtype(stream_dtype) -> torch.dtype:
    if stream_dtype in _STREAM_DTYPES:
        return _STREAM_DTYPES[stream_dtype]
    raise ValueError(
        f"unknown stream_dtype {stream_dtype!r}; expected None, 'f32', 'bf16' "
        "or a torch dtype"
    )


def _check_resident(bank_resident: str) -> None:
    if bank_resident == "hbm":
        raise NotImplementedError(
            'bank_resident="hbm" (the TPU ring through VMEM) is kernel B6, not '
            "ported yet: ROADMAP queue B, B6. On the card the bank lives in "
            'device memory; use "auto" or "vmem".'
        )
    if bank_resident not in ("vmem", "auto"):
        raise ValueError(
            f"unknown bank_resident {bank_resident!r}; expected 'vmem', 'hbm' or 'auto'"
        )


def bank_tiling(b: int, b_tile: int | None):
    """Resolve the bank tiling for B models: ``(effective_b_tile,
    n_bank_tiles)``, the tile rounded up to a multiple of 8 (default: one
    tile holding the whole bank)."""
    bt = -(-b // 8) * 8 if b_tile is None else -(-b_tile // 8) * 8
    return bt, -(-b // bt)


def ovr_group_tiling(b: int, n_classes: int, b_tile: int | None):
    """Resolve the ovr epilogue's tiling: ``(nc_pad, g_tile, padded_groups)``.

    Each group's ``n_classes`` lanes are padded to a multiple of 8
    (``nc_pad``) and the bank is tiled in whole groups, so a group's argmax
    never crosses a tile.
    """
    g = b // n_classes
    nc_pad = -(-n_classes // 8) * 8
    g_tile = g if b_tile is None else max(1, b_tile // nc_pad)
    return nc_pad, g_tile, -(-g // g_tile) * g_tile


def _pad_to(x: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    """Zero-pad ``axis`` of ``x`` up to a multiple of ``mult``."""
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - axis - 1) + [0, pad]
    return F.pad(x, widths)


def _vec(v, b: int, device, dtype=torch.float32) -> torch.Tensor:
    return as_tensor(v, device, dtype).broadcast_to((b,))


def streamsvm_fit_many(
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
    device=None,
) -> Ball:
    """One-pass Algorithm 1 for a bank of B models through kernel B1.

    X: (N, D) shared stream; Y: (B, N) per-model label signs in {-1, +1}
    (classes x C-grid flatten onto B). A sign of 0 makes a row inert for
    that model. cs: scalar or (B,) per-model C. Starts from ``balls`` (a
    Ball stacked on a leading B axis) when given; otherwise row 0 seeds
    every model (``w0 = Y[:, 0] X[0]``, r0 = 0, xi2_0 = gain, m0 = 1) and
    the stream starts at row 1. ``variant``: "exact" (slack gain 1/C) or
    "paper-listing" (gain 1). ``b_tile`` pads the bank to whole tiles of a
    multiple of 8 models; the result does not depend on it.
    ``stream_dtype="bf16"`` rounds the streamed X/Y only. Returns a stacked
    Ball on the device of the inputs.
    """
    if variant in ("lookahead", "lookahead-paper") or lookahead is not None:
        raise NotImplementedError(
            f"variant={variant!r}, lookahead={lookahead!r}: fused Algorithm 2 "
            "is kernel B3, not ported yet: ROADMAP A8"
        )
    if variant not in ("exact", "paper-listing"):
        raise ValueError(
            f"unknown variant {variant!r}; expected 'exact', 'paper-listing', "
            "'lookahead' or 'lookahead-paper'"
        )
    _check_resident(bank_resident)
    dev = pick_device(device, X, Y, None if balls is None else balls.w)
    X, Y = as_tensor(X, dev), as_tensor(Y, dev)
    b, n_y = Y.shape
    n, d = X.shape
    if n_y != n:
        raise ValueError(
            f"Y must be (B, N) sign rows matching X: got Y.shape={tuple(Y.shape)}, "
            f"X.shape={tuple(X.shape)}"
        )
    sdt = _resolve_stream_dtype(stream_dtype)
    cs = _vec(cs, b, dev)
    c_inv = 1.0 / cs
    gain = torch.ones_like(c_inv) if variant == "paper-listing" else c_inv
    if balls is None:
        w0 = Y[:, 0:1] * X[0][None, :]
        r0 = torch.zeros((b,), dtype=torch.float32, device=dev)
        xi20, m0 = gain, torch.ones((b,), dtype=torch.int32, device=dev)
        X, Y = X[1:], Y[:, 1:]
        n -= 1
    else:
        w0, r0, xi20, m0 = (as_tensor(v, dev) for v in balls)
    if n == 0:  # nothing (left) to stream: the starting state is the answer
        return Ball(
            w=w0.float(),
            r=_vec(r0, b, dev).clone(),
            xi2=_vec(xi20, b, dev).clone(),
            m=_vec(m0, b, dev, torch.int32).clone(),
        )
    # Pad models to whole bank tiles; padded lanes carry sign 0, C = 1,
    # gain 1 and r = +inf, so they never violate, and are sliced off below.
    bt, _ = bank_tiling(b, b_tile)
    bp = -(-b // bt) * bt
    live = torch.arange(bp, device=dev) < b
    Xp = _pad_to(X.float(), block_n, 0).to(sdt)
    Yp = _pad_to(_pad_to(Y.float(), block_n, 1), bp, 0).to(sdt)
    W0p = _pad_to(w0.float(), bp, 0)
    pad1 = lambda v, dt=torch.float32: _pad_to(_vec(v, b, dev, dt), bp, 0)
    W, r, xi2, m = streamsvm_scan_many(
        Xp,
        Yp,
        W0p,
        torch.where(live, pad1(r0), torch.inf),
        pad1(xi20),
        torch.where(live, pad1(c_inv), 1.0),
        pad1(m0, torch.int32),
        torch.where(live, pad1(gain), 1.0),
        n_valid=n,
        block_n=block_n,
    )
    return Ball(w=W[:b], r=r[:b], xi2=xi2[:b], m=m[:b])


def predict_bank(
    X,
    W,
    *,
    epilogue: str = "scores",
    n_classes: int | None = None,
    k: int | None = None,
    q_block: int = 256,
    b_tile: int | None = None,
    stream_dtype=None,
    bank_resident: str = "auto",
    device=None,
):
    """Score (Q, D) queries against a (B, D) bank through kernel B2.

    epilogue:
      "scores"          -> (Q, B) f32 margins, no bias
      "ovr", n_classes= -> ((Q, G) int32, (Q, G) f32): winning class and its
                           margin per C-grid group, G = B // n_classes, the
                           bank class-major within each group (model =
                           g * n_classes + class)
      "topk", k=        -> ((Q, k) f32, (Q, k) int32) descending top-k model
                           scores and ids per query, ties to the lowest id
    q_block: query rows per tile; b_tile: bank lanes per tile (for "ovr",
    whole padded groups); stream_dtype: None/"f32" or "bf16" queries.
    """
    _check_resident(bank_resident)
    dev = pick_device(device, X, W)
    X, W = as_tensor(X, dev), as_tensor(W, dev, torch.float32)
    q, d = X.shape
    b, dw = W.shape
    if dw != d:
        raise ValueError(
            f"queries and bank must share the feature axis: got X.shape="
            f"{tuple(X.shape)}, W.shape={tuple(W.shape)}"
        )
    if epilogue not in ("scores", "ovr", "topk"):
        raise ValueError(
            f"unknown epilogue {epilogue!r}; expected 'scores', 'ovr' or 'topk'"
        )
    if epilogue != "ovr" and n_classes is not None:
        raise ValueError(
            f"n_classes={n_classes} requires epilogue='ovr' (got epilogue={epilogue!r})"
        )
    if epilogue != "topk" and k is not None:
        raise ValueError(f"k={k} requires epilogue='topk' (got epilogue={epilogue!r})")
    if epilogue == "ovr" and (n_classes is None or n_classes < 1 or b % n_classes):
        raise ValueError(
            f"epilogue='ovr' needs n_classes >= 1 dividing B: got "
            f"n_classes={n_classes}, B={b}"
        )
    if epilogue == "topk" and (k is None or not (1 <= k <= b)):
        raise ValueError(f"epilogue='topk' needs 1 <= k <= B: got k={k}, B={b}")
    Xp = _pad_to(X.float(), q_block, 0).to(_resolve_stream_dtype(stream_dtype))

    if epilogue == "ovr":
        g = b // n_classes
        nc_pad, g_tile, gp = ovr_group_tiling(b, n_classes, b_tile)
        Wp = _pad_to(_pad_to(W.reshape(g, n_classes, d), nc_pad, 1), gp, 0)
        lane = torch.arange(gp * nc_pad, device=dev)
        live = (lane % nc_pad < n_classes) & (lane // nc_pad < g)
        bias = torch.where(live, 0.0, NEG_MASK).to(torch.float32)
        cls, margin = predict_bank_fused(
            Xp, Wp.reshape(gp * nc_pad, d), bias, epilogue="ovr", q_block=q_block,
            b_tile=g_tile * nc_pad, nc_pad=nc_pad,
        )
        return cls[:q, :g], margin[:q, :g]

    bt, _ = bank_tiling(b, b_tile)
    bp = -(-b // bt) * bt
    Wp = _pad_to(W, bp, 0)
    bias = torch.where(torch.arange(bp, device=dev) < b, 0.0, NEG_MASK).to(torch.float32)
    if epilogue == "topk":
        vals, ids = predict_bank_fused(
            Xp, Wp, bias, epilogue="topk", q_block=q_block, b_tile=bt, k=k
        )
        return vals[:q], ids[:q]
    scores = predict_bank_fused(Xp, Wp, bias, epilogue="scores", q_block=q_block, b_tile=bt)
    return scores[:q, :b]

