"""P1 and P2: the paper's two single-pass baselines with a recursion over the
stream, the perceptron and Pegasos.

Neither replaces a TPU kernel: the reference computes each as a
``lax.scan`` (``repro/baselines/perceptron.py:12-20`` over the rows,
``repro/baselines/pegasos.py:28-42`` over the steps of k rows), which an
eager torch loop would pay in several launches a row. So each is a kernel:

P1  ``perceptron_scan``: the perceptron on B4's walk
    (``csrc/streamsvm_single.cu``, ``single_kernel<WS, true>``): the block's
    margins against its starting w, a warp ballot for the next mistake,
    whose step adds the signed Gram's row to the later margins, and the
    block's deferred update. Its layout is B4's ``single_plan``.
P2  ``pegasos_scan``: Pegasos in the layout ``pegasos_plan`` picks by k.
    "walk": B4's walk with Pegasos' rule and the step's decay deferred
    (``csrc/streamsvm_single.cu``, ``single_kernel<WS, PEG>``): blocks of
    whole steps, the margins against the block's starting w scaled by the
    product of the factors of the steps since the last round, one round a
    step with a violation (or whose projection binds), and the block's
    deferred pass, which replays each step's f32 operations column by
    column; B4's staging. Else the step form on one CTA
    (``csrc/baselines.cu``): "staged", w in shared memory with the steps'
    rows staged a step ahead, or "in place", w in device memory and the
    rows read where they lie.

Each wrapper dispatches on the device of ``X``: a CPU tensor runs its
``*_plain`` twin (the reference's scan body as a loop in plain PyTorch), a
CUDA tensor launches the kernel, or raises. The sums over D (and Pegasos'
|w|) are taken in another order by the kernels, so they are held to the
plain versions within the engine tolerance, with equal decisions, or a
parting certified as an f32 tie. ``flags=`` (a uint8 (N,) tensor) receives
each row's decision (a mistake; a violation), for finding a parting.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .streamsvm_scan import (
    BLOCK_ROWS, SINGLE_DC, SMEM_PER_BLOCK, _single_lib, _vec16, single_plan, single_smem)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: The ring slots of P2's staged layout (``RING`` in csrc/baselines.cu),
#: and its warps' partial sums (``WARPS`` floats).
PEGASOS_RING, PEGASOS_WARPS = 2, 8
#: The largest k at which ``pegasos_plan`` takes the walk (which takes k up
#: to BLOCK_ROWS): where ``tools/pegasos_layouts.py`` timed it faster than
#: the step form on the card.
PEGASOS_WALK_MAX_K = 8


def _pegasos_lib() -> ctypes.CDLL:
    lib = _build.load("baselines")
    lib.pegasos_sweep.argtypes = [_P] * 4 + [_I] * 3 + [_F] + [_I] * 2 + [_P]
    lib.pegasos_sweep.restype = ctypes.c_int
    lib.pegasos_dyn_bytes_c.argtypes = [_I] * 3
    lib.pegasos_dyn_bytes_c.restype = ctypes.c_long
    return lib


def _walk_lib() -> ctypes.CDLL:
    lib = _single_lib()
    lib.perceptron_single.argtypes = [_P] * 6 + [_I] * 6 + [_P]
    lib.perceptron_single.restype = ctypes.c_int
    lib.pegasos_single.argtypes = [_P] * 5 + [_I] * 2 + [_F] + [_I] * 4 + [_P]
    lib.pegasos_single.restype = ctypes.c_int
    lib.pegasos_single_dyn_bytes.argtypes = [_I] * 3
    lib.pegasos_single_dyn_bytes.restype = ctypes.c_long
    lib.pegasos_single_block_rows.argtypes = [_I]
    lib.pegasos_single_block_rows.restype = ctypes.c_int
    return lib


def _check(X, y, flags):
    n = X.shape[0]
    if X.ndim != 2 or y.shape != (n,):
        raise ValueError(f"X must be (N, D) and y (N,): got {tuple(X.shape)}, {tuple(y.shape)}")
    if flags is not None and (flags.shape != (n,) or flags.dtype != torch.uint8
                              or flags.device != X.device):
        raise ValueError(f"flags must be a uint8 (N,)=({n},) tensor on {X.device}")


# ---------------------------------------------------------------------------
# P1: the perceptron
# ---------------------------------------------------------------------------


def perceptron_scan_plain(X, y, *, flags=None):
    """The reference's scan body as a row loop: a mistake is
    ``y (w . x) <= 0`` on the w before the row, and adds ``y x`` to w.
    Returns ``(w, n_updates)``, n_updates a 0-d int32."""
    _check(X, y, flags)
    w = torch.zeros(X.shape[1], dtype=torch.float32, device=X.device)
    m = torch.zeros((), dtype=torch.int32, device=X.device)
    marks = []
    for x, yn in zip(X.float(), y.float()):
        mistake = yn * (w @ x) <= 0.0
        w = torch.where(mistake, w + yn * x, w)
        m = m + mistake.to(torch.int32)
        if flags is not None:
            marks.append(mistake)
    if flags is not None and marks:
        flags.copy_(torch.stack(marks).to(torch.uint8))
    return w, m


def perceptron_scan(X, y, *, flags=None):
    """P1 on the device of ``X``: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. X: (N, D) f32; y: (N,) f32 signs in
    {-1, 1}. Returns ``(w, n_updates)``."""
    if X.device.type == "cpu":
        return perceptron_scan_plain(X, y, flags=flags)
    if X.device.type != "cuda":
        raise ValueError(f"perceptron_scan runs on cuda or cpu, not {X.device}")
    _check(X, y, flags)
    if X.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError(f"X and y must be float32: got {X.dtype}, {y.dtype}")
    dev = X.device
    n, d = X.shape
    X, y = X.contiguous(), y.contiguous()
    w = torch.zeros(d, dtype=torch.float32, device=dev)
    m = torch.zeros(1, dtype=torch.int32, device=dev)
    if n == 0:
        return w, m[0]
    plan = single_plan(d)
    lib = _walk_lib()
    bn = lib.streamsvm_single_block_rows()
    G = torch.empty(((n + bn - 1) // bn) * bn * bn, device=dev, dtype=torch.float32)
    err = lib.perceptron_single(
        X.data_ptr(), y.data_ptr(), G.data_ptr(), w.data_ptr(), m.data_ptr(),
        0 if flags is None else flags.data_ptr(), n, n, d, int(plan["w_in_smem"]),
        plan["chunk"], _vec16(X), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "perceptron_single")
    perceptron_scan.launches += 1
    return w, m[0]


perceptron_scan.launches = 0  # kernel launches, read by chip_smoke.py


# ---------------------------------------------------------------------------
# P2: Pegasos
# ---------------------------------------------------------------------------


def pegasos_scalars(lam, k, steps):
    """Step t's ``(1 - eta lam, -eta / k)`` with ``eta = 1 / (lam (t + 1))``,
    and the projection radius ``1 / sqrt(lam)``: the reference's f32
    operations, each rounded on its own (numpy float32 rounds as the kernel
    does). Returns ``(factor (T,), coef (T,), radius)`` as numpy float32."""
    lam = np.float32(lam)
    t = np.arange(steps, dtype=np.float32)
    eta = np.float32(1.0) / (lam * (t + np.float32(1.0)))
    return (np.float32(1.0) - eta * lam, -eta / np.float32(k),
            np.float32(1.0) / np.sqrt(lam))


def pegasos_smem(d: int, k: int, staged: bool) -> dict:
    """The step form's dynamic shared memory (its only shared memory), bytes
    by term: the staged layout's ring of PEGASOS_RING steps' rows and signs
    and its w row (D rounded up to 8), then the step's -(viol y) and the
    warps' partial sums; the in-place layout has the last two only."""
    ring = PEGASOS_RING if staged else 0
    return {
        "stream_ring": ring * k * d * 4,
        "sign_ring": ring * k * 4,
        "w_row": -(-d // 8) * 8 * 4 if staged else 0,
        "step_state": (k + PEGASOS_WARPS) * 4,
    }


def walk_rows(k: int) -> int:
    """Rows a block of P2's walk at k rows a step: whole steps, at most
    BLOCK_ROWS (``pegasos_single_block_rows``)."""
    if not 1 <= k <= BLOCK_ROWS:
        raise ValueError(f"the walk takes 1 <= k <= {BLOCK_ROWS}: got k={k}")
    return BLOCK_ROWS // k * k


def walk_smem(d: int, *, chunk: int, w_in_smem: bool) -> dict:
    """The walk's dynamic shared memory (its only shared memory): B4's
    ``single_smem`` and the walk's state (``PEG_STATE`` floats): the warps'
    sums of |w|^2 (PEGASOS_WARPS doubles) and each row's step factor,
    coefficient and scale (BLOCK_ROWS floats each)."""
    return dict(single_smem(d, w_in_smem=w_in_smem, chunk=chunk),
                walk_state=PEGASOS_WARPS * 8 + 3 * BLOCK_ROWS * 4)


def pegasos_layouts(d: int, k: int, *, smem_budget: int | None = None) -> list[dict]:
    """Every layout of P2 at k rows a step and D features that fits
    ``smem_budget`` (default and cap: the card's SMEM_PER_BLOCK), in the
    plan's order of preference: the walk (k <= BLOCK_ROWS) in B4's three
    layouts (whole 32-row blocks staged with w in shared memory, SINGLE_DC-
    column chunks with w in shared memory, the same with w in device
    memory), then the step form "staged" and "in place". A plan holds
    ``layout`` and ``smem`` (bytes by term); the walk's also ``rows`` (a
    block's), ``chunk`` and ``w_in_smem``, the step form's ``staged``."""
    limit = SMEM_PER_BLOCK if smem_budget is None else min(int(smem_budget), SMEM_PER_BLOCK)
    plans = []
    if 1 <= k <= BLOCK_ROWS:
        for chunk, ws in ((-(-d // 4) * 4, True), (SINGLE_DC, True), (SINGLE_DC, False)):
            plans.append(dict(layout="walk", rows=walk_rows(k), chunk=chunk, w_in_smem=ws,
                              smem=walk_smem(d, chunk=chunk, w_in_smem=ws)))
    for staged in (True, False):
        plans.append(dict(layout="staged" if staged else "in place", staged=staged,
                          smem=pegasos_smem(d, k, staged)))
    return [p for p in plans if sum(p["smem"].values()) <= limit]


def pegasos_plan(d: int, k: int, *, smem_budget: int | None = None) -> dict:
    """P2's layout for k rows a step at D features under ``smem_budget``
    (default and cap: the card's SMEM_PER_BLOCK): the walk where k <=
    PEGASOS_WALK_MAX_K (in the first of B4's layouts that fits), else the
    step form, "staged" where its ring fits, else "in place". A budget of a
    layout's own bytes forces it where no earlier one fits below it. Returns
    one of ``pegasos_layouts``; raises where not even the in-place layout
    fits."""
    for plan in pegasos_layouts(d, k, smem_budget=smem_budget):
        if plan["layout"] != "walk" or k <= PEGASOS_WALK_MAX_K:
            return plan
    need = sum(pegasos_smem(d, k, False).values())
    raise ValueError(f"pegasos: k={k} rows a step need {need} B of shared memory, beyond the "
                     f"budget {smem_budget if smem_budget is not None else SMEM_PER_BLOCK} B")


def _pegasos_args(X, y, lam, k, flags):
    _check(X, y, flags)
    if k < 1 or X.shape[0] % k != 0:
        raise ValueError(f"N={X.shape[0]} must be a positive multiple of k={k} (the sweep "
                         "drops the trailing partial step before the call)")
    if not lam > 0:
        raise ValueError(f"lam must be positive: got {lam}")


def pegasos_scan_plain(X, y, lam, k, *, flags=None, smem_budget=None):
    """The reference's scan body as a step loop, with its f32 scalars
    (``pegasos_scalars``): the k margins against the step's w, the masked
    sub-gradient step, the projection onto the ball of radius 1/sqrt(lam).
    X: (T k, D); returns w (D,). ``smem_budget`` is the kernel's and changes
    nothing here."""
    _pegasos_args(X, y, lam, k, flags)
    n, d = X.shape
    steps = n // k
    factor, coef, radius = pegasos_scalars(lam, k, steps)
    Xb, yb = X.float().reshape(steps, k, d), y.float().reshape(steps, k)
    w = torch.zeros(d, dtype=torch.float32, device=X.device)
    marks = []
    for t in range(steps):
        x, ys = Xb[t], yb[t]
        viol = (ys * (x @ w) < 1.0).float()
        s = (-(viol * ys)[:, None] * x).sum(0)
        w = float(factor[t]) * w + float(coef[t]) * s
        w = w * torch.clamp(float(radius) / torch.clamp(torch.linalg.vector_norm(w), min=1e-12),
                            max=1.0)
        if flags is not None:
            marks.append(viol)
    if flags is not None and marks:
        flags.copy_(torch.cat(marks).to(torch.uint8))
    return w


def pegasos_scan(X, y, lam, k, *, flags=None, smem_budget=None):
    """P2 on the device of ``X``: the CUDA kernel for a CUDA tensor (in
    ``pegasos_plan``'s layout under ``smem_budget``), the plain version for
    a CPU tensor. X: (T k, D) f32; y: (T k,) f32 signs; lam > 0; k >= 1.
    Returns w (D,)."""
    if X.device.type == "cpu":
        return pegasos_scan_plain(X, y, lam, k, flags=flags)
    if X.device.type != "cuda":
        raise ValueError(f"pegasos_scan runs on cuda or cpu, not {X.device}")
    _pegasos_args(X, y, lam, k, flags)
    if X.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError(f"X and y must be float32: got {X.dtype}, {y.dtype}")
    X, y = X.contiguous(), y.contiguous()
    w = torch.zeros(X.shape[1], dtype=torch.float32, device=X.device)
    if X.shape[0] == 0:
        return w
    _launch(pegasos_plan(X.shape[1], k, smem_budget=smem_budget), X, y, lam, k, w, flags)
    pegasos_scan.launches += 1
    return w


def _launch(plan, X, y, lam, k, w, flags) -> None:
    """Launch P2 in the layout ``plan`` (one of ``pegasos_layouts``) over the
    checked, contiguous f32 X (T k, D) and y on the card, T >= 1, with w
    (D,) zero, updated in place."""
    dev = X.device
    n, d = X.shape
    stream = torch.cuda.current_stream(dev).cuda_stream
    fptr = 0 if flags is None else flags.data_ptr()
    lam32 = float(np.float32(lam))
    if plan["layout"] == "walk":
        lib = _walk_lib()
        G = torch.empty(-(-n // plan["rows"]) * BLOCK_ROWS * BLOCK_ROWS, device=dev,
                        dtype=torch.float32)
        err = lib.pegasos_single(
            X.data_ptr(), y.data_ptr(), G.data_ptr(), w.data_ptr(), fptr, n, d, lam32, k,
            int(plan["w_in_smem"]), plan["chunk"], _vec16(X), stream,
        )
        _build.check(err, "pegasos_single")
        return
    err = _pegasos_lib().pegasos_sweep(
        X.data_ptr(), y.data_ptr(), w.data_ptr(), fptr, n // k, k, d, lam32,
        int(plan["staged"]), _vec16(X), stream,
    )
    _build.check(err, "pegasos_sweep")


pegasos_scan.launches = 0  # kernel launches, read by chip_smoke.py
