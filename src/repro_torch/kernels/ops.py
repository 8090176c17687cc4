"""Public wrappers around the port's kernels: padding, tiling, dtype policy.

These are the entry points the rest of the port uses. They keep the JAX
package's padding, seeding and state packing (``repro/kernels/ops.py``), so
the two agree model for model; the 128-lane padding of D (and the Gram's
(8, 128)-aligned tiles and 512-column D padding) are TPU tiling rules and
are not kept. Each runs on the device its inputs name (see
``repro_torch._device``): the kernels (B1 and B3 for a bank, B4 for one
model, B2 to predict, B5 for a Gram block, B6 for a bank through the
ring) launch on a CUDA tensor and run their plain versions on a CPU tensor.

Dtype policy
------------
``stream_dtype`` is the precision of the *streamed* tiles: the (N, D) data
and (B, N) signs of a fit, the (Q, D) queries of a predict. ``"bf16"`` halves
those bytes. The bank, the ball scalars and every accumulator stay f32.

Bank residency
--------------
``bank_resident`` chooses the kernel layout: ``"vmem"`` runs B1 / B3 / B2,
``"hbm"`` runs B6, the ring (``streamsvm_scan_many_ring``,
``predict_bank_ring``), and ``"auto"`` picks by the byte models below. On
the card the bank lives in device memory either way, and both layouts give
the same bits; what they differ in is shared memory per CTA and data
movement. The byte models (``engine_vmem_bytes``, ``predict_vmem_bytes``,
``kernel_engine_vmem_bytes``) keep the reference's names and signatures
but return, by term, the shared memory per CTA of the kernel the call
would launch: static (as declared) plus dynamic (as requested at launch).
The budget they are held to (``vmem_budget_bytes``) defaults to
``DEFAULT_VMEM_BUDGET_BYTES``, the H100's per-block opt-in limit, 232,448 B
(227 KB: the ``hopper-kernels`` guide; CUDA's
``cudaDevAttrMaxSharedMemoryPerBlockOptin``). B1, B3 and B2 keep no
whole-bank scratch: B1 and B3 hold one CTA's tile of the bank (or, for B3
with few live models, one model's row and window) where it fits the budget
and fall back to the column-chunked kernels where it does not
(``scan_plan``), whose bytes (``SCAN_SMEM``, 25,888 B) do not grow with B or
D. So ``"vmem"`` runs under every budget of at least those bytes, and
``"auto"`` resolves to ``"vmem"`` there for every B and D; it reaches
``"hbm"`` only under a smaller budget (the TPU flips near
B * D * 4 = 16 MiB).
"""
from __future__ import annotations

import functools
import os

import torch
import torch.nn.functional as F

from .._device import as_tensor, pick_device
from ..core.meb import Ball
from .gram import GRAM_SMEM, gram_fused, row_norms, tree_sum
from .kernel_bank import rows_plan
from .predict import (
    NEG_MASK,
    PREDICT_RING_SMEM,
    PREDICT_SMEM,
    predict_bank_fused,
    predict_bank_ring,
    topk_state_bytes,
)
from .streamsvm_scan import (
    SMEM_PER_BLOCK,
    ring_plan,
    scan_plan,
    streamsvm_scan,
    streamsvm_scan_many,
    streamsvm_scan_many_ring,
)

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


# ---------------------------------------------------------------------------
# Residency policy: the shared-memory byte models and the budget
# ---------------------------------------------------------------------------

#: Default shared-memory budget per CTA for the "auto" policy and the
#: preflight: the H100's per-block opt-in limit (see the module docstring).
#: Overridable per call (``vmem_budget_bytes=``) and per process
#: (``REPRO_VMEM_BUDGET_BYTES``).
DEFAULT_VMEM_BUDGET_BYTES = SMEM_PER_BLOCK

_BANK_RESIDENCIES = ("vmem", "hbm", "auto")


def _check_resident(bank_resident: str) -> None:
    if bank_resident not in _BANK_RESIDENCIES:
        raise ValueError(
            f"unknown bank_resident {bank_resident!r}; expected one of "
            f"{_BANK_RESIDENCIES}"
        )


def vmem_budget_bytes(override: int | None = None) -> int:
    """The shared-memory budget the residency policy checks against, in
    bytes: ``override``, else ``REPRO_VMEM_BUDGET_BYTES``, else the default."""
    if override is not None:
        return int(override)
    env = os.environ.get("REPRO_VMEM_BUDGET_BYTES")
    return int(env) if env else DEFAULT_VMEM_BUDGET_BYTES


_vmem_budget = vmem_budget_bytes  # the entry points' keyword shadows the name


def engine_vmem_bytes(
    b: int,
    d: int,
    *,
    block_n: int = 256,
    b_tile: int | None = None,
    stream_dtype=None,
    lookahead_max: int | None = None,
    bank_resident: str = "vmem",
    smem_budget: int | None = None,
) -> dict:
    """Shared memory per CTA of the training kernel, bytes by term.

    ``"vmem"``: B1 or B3 in the layout ``scan_plan`` gives the padded bank
    (B to whole ``b_tile`` tiles) with ``b`` live models: the resident tile
    (grows with D, not with B), B3's small layout (one model's row and,
    where it fits, its window) or the chunked kernels (``SCAN_SMEM``,
    whatever B and D). It depends on the stream dtype (the chunks are staged
    raw), never on block_n. ``"hbm"``: B6's
    ``scan_ring_kernel`` at the layout ``ring_plan`` gives the padded bank
    (B to whole ``b_tile`` tiles), also staged raw: its bytes grow with the
    tiles per CTA and, for owned rows, with D, never with B at a fixed number
    of tiles per CTA. ``smem_budget`` (the port's own keyword; default the
    card's limit): B1 and B3 take a layout only where it fits it
    (``scan_plan``: 8 models per CTA, then 4, then the chunked kernels, whose
    bytes are the floor); the ring takes owned whole rows only where they
    fit it, else it cycles 128-column chunks, else 32-column chunks (the
    lean layout, below the chunked kernels' bytes). The ring's lookahead
    windows stay in device memory.
    """
    _check_resident(bank_resident)
    bt, n_tiles = bank_tiling(b, b_tile)
    if bank_resident != "hbm":
        return scan_plan(
            bt * n_tiles, d, lookahead_max=lookahead_max, n_live=b,
            dtype=_resolve_stream_dtype(stream_dtype), smem_budget=smem_budget,
        )["smem"]
    return ring_plan(
        bt * n_tiles, d, lookahead=lookahead_max is not None,
        dtype=_resolve_stream_dtype(stream_dtype), smem_budget=smem_budget,
    )["smem"]


def predict_vmem_bytes(
    b: int,
    d: int,
    *,
    q_block: int = 256,
    b_tile: int | None = None,
    stream_dtype=None,
    epilogue: str = "scores",
    n_classes: int | None = None,
    k: int | None = None,
    bank_resident: str = "vmem",
) -> dict:
    """Shared memory per CTA of the predict kernel, bytes by term: B2's
    ``predict_kernel`` (``"vmem"``) or B6's ``predict_ring_kernel``
    (``"hbm"``), plus the topk epilogue's running lists where the launch
    keeps them in shared memory (k <= ``TOPK_SMEM_MAX_K``; past it they
    live in the outputs, in device memory, and count 0). Neither holds the
    bank: both stage chunks of it through one arena whatever tile the launch
    picks, so the bytes do not grow with B, D or Q. The ring's merge waits
    on a cluster barrier where B2's needs a flag, so the ring is 16 B
    smaller."""
    _check_resident(bank_resident)
    out = dict(PREDICT_RING_SMEM if bank_resident == "hbm" else PREDICT_SMEM)
    out["epilogue_state"] = topk_state_bytes(k) if epilogue == "topk" else 0
    return out


def kernel_engine_vmem_bytes(
    b: int,
    d: int,
    *,
    coreset_size: int,
    block_n: int = 256,
    s_tile: int | None = None,
    stream_dtype=None,
    eviction: str = "smallest-coef",
    smem_budget: int | None = None,
) -> dict:
    """Shared memory per CTA of the kernelized bank engine, bytes by term:
    B5's Gram tiles (``gram_kernel``, ``GRAM_SMEM``) and R1's row recursion
    in the layout ``kernel_bank.rows_plan`` picks for B, S and ``eviction``
    under ``smem_budget`` (the staged layout's blocks, slot state and, for
    "farthest-point", the Kbb slabs; 0 for the first port's layouts, which
    keep their slots in registers or a device scratch). The two are separate
    launches, each held to the budget on its own. What ``s_tile`` caps, the
    (block_n, B * s_tile) K_cs block and the gathered (B * s_tile, D)
    core-set operand, lives in device memory, which no shared-memory budget
    sees."""
    plan = rows_plan(b, coreset_size, farthest=eviction == "farthest-point",
                     smem_budget=smem_budget)
    return {"gram_tiles": GRAM_SMEM, "row_recursion": sum(plan["smem"].values())}


def derive_hbm_b_tile(b: int, byte_model_at, *, vmem_budget: int):
    """Pick a ring tile for an HBM-resident bank when the caller gave none.

    ``byte_model_at(b_tile)`` returns the hbm breakdown for a candidate
    tile; this returns None if the default (one tile holding the bank) fits
    ``vmem_budget``, else the largest power-of-two tile (512 down to 8)
    under it, else 8 (and the preflight raises). A caller's ``b_tile`` is
    never overridden. On the card a tile only pads the bank (the ring's
    unit is a lane group of 8 models), so this nearly always keeps None.
    """
    if sum(byte_model_at(None).values()) <= vmem_budget:
        return None
    for cand in (512, 256, 128, 64, 32, 16, 8):
        if cand < b and sum(byte_model_at(cand).values()) <= vmem_budget:
            return cand
    return 8


def resolve_bank_resident(
    bank_resident: str,
    byte_model,
    *,
    vmem_budget: int,
    what: str,
    shapes: str,
) -> tuple[str, dict]:
    """Resolve the residency policy against the byte model.

    ``byte_model(residency)`` returns the breakdown for one residency.
    "auto" picks "vmem" when its bytes fit ``vmem_budget`` and "hbm"
    otherwise; a forced residency beyond the budget, and a configuration no
    residency fits, raise a ValueError carrying the shapes, the breakdown
    and the budget, before any launch. Returns ``(residency, breakdown)``.
    """
    _check_resident(bank_resident)
    if bank_resident == "auto":
        by = byte_model("vmem")
        if sum(by.values()) <= vmem_budget:
            return "vmem", by
        bank_resident = "hbm"
    by = byte_model(bank_resident)
    total = sum(by.values())
    if total > vmem_budget:
        hint = (
            "shrink the tiles per CTA (the bank), D (owned ring slots hold "
            "whole rows) or the lookahead, or raise the budget"
            if bank_resident == "hbm"
            else 'use bank_resident="hbm" (or "auto"), or shrink the bank'
        )
        raise ValueError(
            f"{what} with {shapes} needs {total} bytes of shared memory per "
            f"CTA under bank_resident={bank_resident!r} (breakdown: {by}), "
            f"exceeding the budget of {vmem_budget} bytes — {hint}. The "
            "budget follows vmem_budget_bytes(): pass vmem_budget_bytes= or "
            "set REPRO_VMEM_BUDGET_BYTES."
        )
    return bank_resident, by


def bank_tiling(b: int, b_tile: int | None):
    """Resolve the bank tiling for B models: ``(effective_b_tile,
    n_bank_tiles)``, the tile rounded up to a multiple of 8 (default: one
    tile holding the whole bank)."""
    bt = -(-b // 8) * 8 if b_tile is None else -(-b_tile // 8) * 8
    return bt, -(-b // bt)


def gram_tiling(m: int, n: int, bm: int, bn: int):
    """The reference's tile resolver for its Gram kernel: the requested
    ``(bm, bn)`` shrunk to the data, bm a multiple of 8 and bn of 128.
    Kept as the public policy the reference's harnesses read; B5's CTA
    tiles on the card are chosen in csrc/gram.cu and do not follow it."""
    bm_ = -(-min(bm, max(8, m)) // 8) * 8
    bn_ = -(-min(bn, max(128, n)) // 128) * 128
    return bm_, bn_


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


def fit_single(X, y, start: Ball, c_inv, gain, *, block_n: int = 256) -> Ball:
    """Continue Algorithm 1 for one model from ``start`` over ``(X, y)``
    through kernel B4, on the device of ``X``. ``c_inv`` is 1/C and ``gain``
    the slack gain; N is padded to a multiple of ``block_n`` with inert
    sign-0 rows. Returns a Ball of 0-d scalars (m int32)."""
    dev = X.device
    n = X.shape[0]
    w0 = as_tensor(start.w, dev, torch.float32)
    r0, xi20 = as_tensor(start.r, dev, torch.float32), as_tensor(start.xi2, dev, torch.float32)
    m0 = as_tensor(start.m, dev, torch.int32)
    if n == 0:  # nothing to stream: the starting state is the answer
        return Ball(w=w0.clone(), r=r0.reshape(()).clone(), xi2=xi20.reshape(()).clone(),
                    m=m0.reshape(()).clone())
    Xp = _pad_to(X.float(), block_n, 0)
    yp = _pad_to(y.float(), block_n, 0)
    w, r, xi2, m = streamsvm_scan(Xp, yp, w0, r0, xi20, c_inv, m0, gain, n_valid=n, block_n=block_n)
    return Ball(w=w, r=r, xi2=xi2, m=m)


def streamsvm_fit(X, y, c, ball: Ball | None = None, *, block_n: int = 256, device=None) -> Ball:
    """One-pass Algorithm 1 for one model through kernel B4.

    X: (N, D); y: (N,) label signs (0: inert row). Starts from ``ball`` if
    given, else from the first example (w = y_0 x_0, r = 0, xi2 = 1/C,
    m = 1: the exact variant) and streams the rest. Returns a Ball of 0-d
    scalars on the device of the inputs.
    """
    dev = pick_device(device, X, y, None if ball is None else ball.w)
    X, y = as_tensor(X, dev, torch.float32), as_tensor(y, dev, torch.float32)
    n, _ = X.shape
    if y.shape != (n,):
        raise ValueError(
            f"y must be (N,) labels matching X: got y.shape={tuple(y.shape)}, "
            f"X.shape={tuple(X.shape)}"
        )
    c_inv = 1.0 / as_tensor(c, dev, torch.float32)
    if ball is None:
        one = torch.ones((), dtype=torch.int32, device=dev)
        ball = Ball(w=y[0] * X[0], r=torch.zeros_like(c_inv), xi2=c_inv, m=one)
        X, y = X[1:], y[1:]
    return fit_single(X, y, ball, c_inv, c_inv, block_n=block_n)


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
    vmem_budget_bytes: int | None = None,
    device=None,
) -> Ball:
    """One-pass Algorithm 1 or 2 for a bank of B models through kernel B1
    or B3 (or B6, the ring, when the residency resolves to "hbm"): one read
    of the stream.

    X: (N, D) shared stream; Y: (B, N) per-model label signs in {-1, +1}
    (classes x C-grid flatten onto B). A sign of 0 makes a row inert for
    that model. cs: scalar or (B,) per-model C. Starts from ``balls`` (a
    Ball stacked on a leading B axis) when given; otherwise row 0 seeds
    every model (``w0 = Y[:, 0] X[0]``, r0 = 0, xi2_0 = gain, m0 = 1) and
    the stream starts at row 1. ``variant``: "exact" / "paper-listing" run
    Algorithm 1 (B1) with slack gain 1/C / 1; "lookahead" /
    "lookahead-paper" run the fused Algorithm 2 (B3) with the same gains and
    per-model windows given by ``lookahead`` (an int, or a length-B tuple of
    ints; default 1), flushed farthest-first when full and after the last
    row. ``b_tile`` pads the bank to whole tiles of a multiple of 8 models;
    the result does not depend on it. ``stream_dtype="bf16"`` rounds the
    streamed X/Y only. ``bank_resident``: "vmem", "hbm" or "auto", resolved
    against ``vmem_budget_bytes`` (see the module docstring); the two
    layouts give the same bits. Returns a stacked Ball on the device of the
    inputs.
    """
    if variant not in ("exact", "paper-listing", "lookahead", "lookahead-paper"):
        raise ValueError(
            f"unknown variant {variant!r}; expected 'exact', 'paper-listing', "
            "'lookahead' or 'lookahead-paper'"
        )
    is_lookahead = variant in ("lookahead", "lookahead-paper")
    if not is_lookahead and lookahead is not None:
        raise ValueError(
            f"lookahead={lookahead!r} requires variant='lookahead' or "
            f"'lookahead-paper' (got variant={variant!r})"
        )
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
    gain = torch.ones_like(c_inv) if variant in ("paper-listing", "lookahead-paper") else c_inv
    if is_lookahead:
        lookahead = 1 if lookahead is None else lookahead
        if isinstance(lookahead, int):
            lookahead = (lookahead,) * b
        lookahead = tuple(int(l) for l in lookahead)
        if len(lookahead) != b or min(lookahead) < 1:
            raise ValueError(
                f"lookahead must be an int >= 1 or a length-B tuple of them: "
                f"got {lookahead} for B={b}"
            )
    l_max = max(lookahead) if is_lookahead else None
    budget = _vmem_budget(vmem_budget_bytes)
    engine_bytes_at = lambda bt_, res: engine_vmem_bytes(
        b, d, block_n=block_n, b_tile=bt_, stream_dtype=sdt, lookahead_max=l_max,
        bank_resident=res, smem_budget=budget,
    )
    if b_tile is None and bank_resident in ("auto", "hbm"):
        vmem_fits = sum(engine_bytes_at(None, "vmem").values()) <= budget
        if bank_resident == "hbm" or not vmem_fits:
            b_tile = derive_hbm_b_tile(
                b, lambda bt_: engine_bytes_at(bt_, "hbm"), vmem_budget=budget
            )
    # The preflight: resolve "auto" and refuse, before any launch, a layout
    # beyond the budget.
    residency, _ = resolve_bank_resident(
        bank_resident,
        lambda res: engine_bytes_at(b_tile, res),
        vmem_budget=budget,
        what="streamsvm_fit_many",
        shapes=(
            f"B={b}, D={d}, block_n={block_n}, b_tile={b_tile}, "
            f"lookahead_max={l_max}, stream_dtype={stream_dtype!r}"
        ),
    )
    scan = functools.partial(
        streamsvm_scan_many_ring if residency == "hbm" else streamsvm_scan_many,
        smem_budget=budget,
    )
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
    # gain 1, L = 1 and r = +inf, so they never violate (or buffer), and
    # are sliced off below.
    bt, _ = bank_tiling(b, b_tile)
    bp = -(-b // bt) * bt
    live = torch.arange(bp, device=dev) < b
    Xp = _pad_to(X.float(), block_n, 0).to(sdt)
    Yp = _pad_to(_pad_to(Y.float(), block_n, 1), bp, 0).to(sdt)
    W0p = _pad_to(w0.float(), bp, 0)
    pad1 = lambda v, dt=torch.float32: _pad_to(_vec(v, b, dev, dt), bp, 0)
    # The vmem path's B3 gets the live count (its small layout leaves the
    # padded lanes alone); the ring walks every lane.
    live_kw = {"n_live": b} if is_lookahead and residency == "vmem" else {}
    W, r, xi2, m = scan(
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
        lookahead=(
            torch.tensor(lookahead + (1,) * (bp - b), dtype=torch.int32, device=dev)
            if is_lookahead else None
        ),
        lookahead_max=l_max,
        **live_kw,
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
    vmem_budget_bytes: int | None = None,
    device=None,
):
    """Score (Q, D) queries against a (B, D) bank through kernel B2 (or B6,
    the ring, when the residency resolves to "hbm").

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
    bank_resident / vmem_budget_bytes: as in ``streamsvm_fit_many``; the
    two layouts give the same bits.
    """
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
    sdt = _resolve_stream_dtype(stream_dtype)
    budget = _vmem_budget(vmem_budget_bytes)
    predict_bytes_at = lambda bt_, res: predict_vmem_bytes(
        b, d, q_block=q_block, b_tile=bt_, stream_dtype=sdt, epilogue=epilogue,
        n_classes=n_classes, k=k, bank_resident=res,
    )
    if b_tile is None and bank_resident in ("auto", "hbm"):
        vmem_fits = sum(predict_bytes_at(None, "vmem").values()) <= budget
        if bank_resident == "hbm" or not vmem_fits:
            b_tile = derive_hbm_b_tile(
                b, lambda bt_: predict_bytes_at(bt_, "hbm"), vmem_budget=budget
            )
    residency, _ = resolve_bank_resident(
        bank_resident,
        lambda res: predict_bytes_at(b_tile, res),
        vmem_budget=budget,
        what="predict_bank",
        shapes=(
            f"Q={q}, B={b}, D={d}, q_block={q_block}, b_tile={b_tile}, "
            f"epilogue={epilogue!r}, stream_dtype={stream_dtype!r}"
        ),
    )
    predict = predict_bank_ring if residency == "hbm" else predict_bank_fused
    Xp = _pad_to(X.float(), q_block, 0).to(sdt)

    if epilogue == "ovr":
        g = b // n_classes
        nc_pad, g_tile, gp = ovr_group_tiling(b, n_classes, b_tile)
        Wp = _pad_to(_pad_to(W.reshape(g, n_classes, d), nc_pad, 1), gp, 0)
        lane = torch.arange(gp * nc_pad, device=dev)
        live = (lane % nc_pad < n_classes) & (lane // nc_pad < g)
        bias = torch.where(live, 0.0, NEG_MASK).to(torch.float32)
        cls, margin = predict(
            Xp, Wp.reshape(gp * nc_pad, d), bias, epilogue="ovr", q_block=q_block,
            b_tile=g_tile * nc_pad, nc_pad=nc_pad,
        )
        return cls[:q, :g], margin[:q, :g]

    bt, _ = bank_tiling(b, b_tile)
    bp = -(-b // bt) * bt
    Wp = _pad_to(W, bp, 0)
    bias = torch.where(torch.arange(bp, device=dev) < b, 0.0, NEG_MASK).to(torch.float32)
    if epilogue == "topk":
        vals, ids = predict(Xp, Wp, bias, epilogue="topk", q_block=q_block, b_tile=bt, k=k)
        return vals[:q], ids[:q]
    scores = predict(Xp, Wp, bias, epilogue="scores", q_block=q_block, b_tile=bt)
    return scores[:q, :b]



def gram(A, B, *, epilogue: str = "linear", gamma=1.0, bm: int = 256, bn: int = 256,
         bk: int = 512, device=None):
    """Kernel matrix K[i, j] = k(a_i, b_j) through kernel B5: "linear" or
    "rbf" (exp(-gamma max(|a|^2 + |b|^2 - 2<a, b>, 0))). (M, N) f32.

    A may be bf16 (a rounded stream tile; the kernel upcasts it); B is taken
    in f32. ``bm``/``bn``/``bk`` keep the reference's signature: they are
    the TPU's block shape, and the card's kernel tiles its own way, each
    element one f32 sum over d in ascending order whatever the tiling, so
    they change no bit of the result. The row norms are ``row_norms``.
    """
    for name, v in (("bm", bm), ("bn", bn), ("bk", bk)):
        if int(v) < 1:
            raise ValueError(f"{name} must be >= 1, got {v}")
    dev = pick_device(device, A, B)
    A = as_tensor(A, dev)
    if A.dtype != torch.bfloat16:
        A = A.float()
    B = as_tensor(B, dev, torch.float32)
    if B.ndim != 2 or A.ndim != 2 or B.shape[1] != A.shape[1]:
        raise ValueError(
            f"A and B must share the feature axis: got A.shape={tuple(A.shape)}, "
            f"B.shape={tuple(B.shape)}"
        )
    return gram_fused(A, B, row_norms(A), row_norms(B), float(gamma), epilogue=epilogue)


def predict_kernel_bank(
    X,
    points,
    coef,
    *,
    kernel: str = "rbf",
    gamma=1.0,
    epilogue: str = "scores",
    n_classes: int | None = None,
    k: int | None = None,
    q_block: int = 256,
    stream_dtype=None,
    point_norms=None,
    device=None,
):
    """Score (Q, D) queries against a kernelized bank's stored core sets.

    ``points`` is the bank's (B, S, D) core-set buffer and ``coef`` its
    (B, S) signed coefficients (free slots hold 0). One B5 launch evaluates
    k(queries, every model's core set) as a (Q, B*S) block; the readout is
    then ``scores[q, b] = sum_s coef[b, s] k(x_q, points[b, s])``, summed
    by ``tree_sum`` so a query's scores do not depend on the other queries
    of the call (served scores equal ``kernel_bank_decision`` bit for bit).

      "scores"          -> (Q, B) f32 margins
      "ovr", n_classes= -> ((Q, G) int32, (Q, G) f32) per C-grid group,
                           G = B // n_classes, class-major
      "topk", k=        -> ((Q, k) f32, (Q, k) int32) descending, ties to
                           the lowest model id

    q_block: the server's microbatch height (the Gram takes every row at
    once here). stream_dtype: "bf16" rounds the queries; the core sets and
    coefficients stay f32. point_norms: the (B*S,) ``row_norms`` of the
    flattened core sets, for a caller that scores one bank many times
    (``BankServer`` computes them once per bank); computed here if None.
    """
    dev = pick_device(device, X, points, coef)
    X = as_tensor(X, dev)
    points, coef = as_tensor(points, dev, torch.float32), as_tensor(coef, dev, torch.float32)
    q, d = X.shape
    b, s, dp = points.shape
    if dp != d:
        raise ValueError(
            f"queries and core-set points must share the feature axis: got "
            f"X.shape={tuple(X.shape)}, points.shape={tuple(points.shape)}"
        )
    if coef.shape != (b, s):
        raise ValueError(
            f"coef must be (B, S) matching points: got coef.shape="
            f"{tuple(coef.shape)}, points.shape={tuple(points.shape)}"
        )
    if kernel not in ("linear", "rbf"):
        raise ValueError(f"unknown kernel {kernel!r}; expected 'linear' or 'rbf'")
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
    if int(q_block) < 1:
        raise ValueError(f"q_block must be >= 1, got {q_block}")
    Xq = X.float().to(_resolve_stream_dtype(stream_dtype))
    P = points.reshape(b * s, d)
    pn = row_norms(P) if point_norms is None else as_tensor(point_norms, dev, torch.float32)
    if pn.shape != (b * s,):
        raise ValueError(f"point_norms must be (B*S,)={(b * s,)}: got {tuple(pn.shape)}")
    K = gram_fused(Xq, P, row_norms(Xq), pn, float(gamma), epilogue=kernel)
    scores = tree_sum(K.reshape(q, b, s) * coef)
    if epilogue == "scores":
        return scores
    if epilogue == "ovr":
        grouped = scores.reshape(q, b // n_classes, n_classes)
        return torch.argmax(grouped, dim=-1).to(torch.int32), grouped.amax(dim=-1)
    vals, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), ids[:, :k].to(torch.int32)
