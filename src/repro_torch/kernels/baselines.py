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
    column; B4's staging. "blocks": the same walk over blocks of several
    steps (``csrc/baselines.cu``, ``pegasos_blocks_kernel``; rows a block
    k floor(R / k), the block's Gram in shared memory, one warp round a step
    with a violation, the deferred replay reading only the violating rows;
    the rows split by columns over a cluster of CTAs; for wide rows 16-byte
    aligned, at most PEGASOS_BLOCKS_MAX_K rows a step). Else the step form on
    one CTA (``csrc/baselines.cu``): "staged", w in shared memory with the
    steps' rows staged a step ahead, or "in place", w in device memory and
    the rows read where they lie.

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
#: The rows R asked for by the walk over blocks (a block holds k floor(R / k)
#: rows); the largest k, and the columns a row of a step needs for each of
#: its k rows, at which ``pegasos_plan`` takes it above PEGASOS_WALK_MAX_K
#: (D >= PEGASOS_BLOCKS_D_PER_K k): where ``tools/pegasos_layouts.py`` timed
#: it faster than the step form on an H100 80GB HBM3 at 700 W, on the card
#: alone (mnist89, D = 784: every k from 9 to 64, at k = 20 1.0086 against
#: 2.0288 ms; w3a, D = 300: k = 9 to 24, 4.7758 against 4.7909 ms at 24,
#: 4.4675 against 4.2498 at 32). Its step costs little more on wide rows
#: (the cluster splits them), the step form's grows with k D. On narrow
#: rows its rounds set the pace (synthetic_a, D = 2: the step form wins
#: from k = 16). R = 96, 192 and 224 came within 0.15 ms of 128 at mnist89.
PEGASOS_BLOCKS_R = 128
PEGASOS_BLOCKS_MAX_K = 64
PEGASOS_BLOCKS_D_PER_K = 12
#: The walk over blocks: at most this many steps a block (a lane each) and
#: rows a block (8 a lane): MAX_STEPS and 32 MAX_SLOTS in csrc/baselines.cu.
BLOCKS_MAX_STEPS, BLOCKS_MAX_ROWS = 32, 256
#: The CTAs of its cluster (CLUSTER), each a slice of the columns.
BLOCKS_CLUSTER = 8


def _pegasos_lib() -> ctypes.CDLL:
    lib = _build.load("baselines")
    lib.pegasos_sweep.argtypes = [_P] * 4 + [_I] * 3 + [_F] + [_I] * 2 + [_P]
    lib.pegasos_sweep.restype = ctypes.c_int
    lib.pegasos_dyn_bytes_c.argtypes = [_I] * 3
    lib.pegasos_dyn_bytes_c.restype = ctypes.c_long
    return lib


def _blocks_lib() -> ctypes.CDLL:
    lib = _pegasos_lib()
    lib.pegasos_blocks.argtypes = [_P] * 5 + [_I] * 2 + [_F] + [_I] * 3 + [_P]
    lib.pegasos_blocks.restype = ctypes.c_int
    lib.pegasos_blocks_dyn_bytes.argtypes = [_I] * 2
    lib.pegasos_blocks_cluster.restype = ctypes.c_int
    lib.pegasos_blocks_dyn_bytes.restype = ctypes.c_long
    lib.pegasos_blocks_rows.argtypes = [_I] * 2
    lib.pegasos_blocks_rows.restype = ctypes.c_int
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


def blocks_rows(k: int, r: int) -> int:
    """Rows a block of P2's walk over blocks at k rows a step with R rows
    asked for: k floor(R / k), or 0 where that layout does not take k (no
    whole step, more than BLOCKS_MAX_STEPS steps or BLOCKS_MAX_ROWS rows;
    ``pegasos_blocks_rows``)."""
    if k < 1 or r < k:
        return 0
    rb = r // k * k
    return rb if rb // k <= BLOCKS_MAX_STEPS and rb <= BLOCKS_MAX_ROWS else 0


def blocks_smem(d: int, rows: int) -> dict:
    """The walk over blocks' dynamic shared memory (its only shared memory),
    each of its BLOCKS_CLUSTER CTAs', at ``rows`` rows a block, padded to
    rp = 32 ceil(rows / 32), bytes by term: the warps' |w|^2 sums
    (PEGASOS_WARPS doubles), the block's Gram (rp^2 floats), the w row (D
    rounded up to 8), each row's margin, sign, -(viol y), list entry and its
    step (rp each), each step's factor, coefficient and scale, the list's
    length and the projected steps' mask (130 words), and two sets of the
    CTAs' |w|^2 (doubles) and margin partials (rp floats each)."""
    rp = -(-rows // 32) * 32
    return {
        "wsq_sums": PEGASOS_WARPS * 8,
        "gram": rp * rp * 4,
        "w_row": -(-d // 8) * 8 * 4,
        "row_state": 5 * rp * 4,
        "step_state": (3 * BLOCKS_MAX_STEPS + BLOCKS_MAX_STEPS + 2) * 4,
        "cluster_partials": 2 * BLOCKS_CLUSTER * (2 + rp) * 4,
    }


def pegasos_layouts(d: int, k: int, *, smem_budget: int | None = None,
                    aligned: bool = True) -> list[dict]:
    """Every layout of P2 at k rows a step and D features that fits
    ``smem_budget`` (default and cap: the card's SMEM_PER_BLOCK), in the
    plan's order of preference: the walk (k <= BLOCK_ROWS) in B4's three
    layouts (whole 32-row blocks staged with w in shared memory, SINGLE_DC-
    column chunks with w in shared memory, the same with w in device
    memory), then the walk over blocks where PEGASOS_BLOCKS_R takes k and
    the rows are 16-byte ``aligned`` with D a multiple of 4, then the step
    form "staged" and "in place". A plan holds ``layout`` and ``smem``
    (bytes by term); the walk's also ``rows`` (a block's), ``chunk`` and
    ``w_in_smem``, the walk over blocks' ``rows``, the step form's
    ``staged``."""
    limit = SMEM_PER_BLOCK if smem_budget is None else min(int(smem_budget), SMEM_PER_BLOCK)
    plans = []
    if 1 <= k <= BLOCK_ROWS:
        for chunk, ws in ((-(-d // 4) * 4, True), (SINGLE_DC, True), (SINGLE_DC, False)):
            plans.append(dict(layout="walk", rows=walk_rows(k), chunk=chunk, w_in_smem=ws,
                              smem=walk_smem(d, chunk=chunk, w_in_smem=ws)))
    rows = blocks_rows(k, PEGASOS_BLOCKS_R)
    if rows and aligned and d % 4 == 0:
        plans.append(dict(layout="blocks", rows=rows, smem=blocks_smem(d, rows)))
    for staged in (True, False):
        plans.append(dict(layout="staged" if staged else "in place", staged=staged,
                          smem=pegasos_smem(d, k, staged)))
    return [p for p in plans if sum(p["smem"].values()) <= limit]


def _planned(plan: dict, d: int, k: int) -> bool:
    """Whether ``pegasos_plan`` may take ``plan`` at k rows a step of D
    features: the walk where k <= PEGASOS_WALK_MAX_K; the walk over blocks
    where PEGASOS_WALK_MAX_K < k <= PEGASOS_BLOCKS_MAX_K and D >=
    PEGASOS_BLOCKS_D_PER_K k; the step form always."""
    if plan["layout"] == "walk":
        return k <= PEGASOS_WALK_MAX_K
    if plan["layout"] == "blocks":
        return (PEGASOS_WALK_MAX_K < k <= PEGASOS_BLOCKS_MAX_K
                and d >= PEGASOS_BLOCKS_D_PER_K * k)
    return True


def pegasos_plan(d: int, k: int, *, smem_budget: int | None = None,
                 aligned: bool = True) -> dict:
    """P2's layout for k rows a step at D features under ``smem_budget``
    (default and cap: the card's SMEM_PER_BLOCK): the walk where k <=
    PEGASOS_WALK_MAX_K (in the first of B4's layouts that fits), the walk
    over blocks (PEGASOS_BLOCKS_R rows asked for) where PEGASOS_WALK_MAX_K <
    k <= PEGASOS_BLOCKS_MAX_K on rows at least PEGASOS_BLOCKS_D_PER_K k wide
    and 16-byte ``aligned`` (``_vec16``), else the step form, "staged" where its
    ring fits, else "in place". A budget of a layout's own bytes forces it
    where no earlier one fits below it. Returns one of ``pegasos_layouts``;
    raises where not even the in-place layout fits."""
    for plan in pegasos_layouts(d, k, smem_budget=smem_budget, aligned=aligned):
        if _planned(plan, d, k):
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


def pegasos_blocks_plain(X, y, lam, k, rows, *, flags=None, dtype=torch.float32,
                         projected=None):
    """The walk over blocks (``pegasos_blocks_kernel``) in plain PyTorch, in
    ``dtype`` (|w|^2 in float64, as the kernel carries it): blocks of
    ``rows`` rows (whole steps, ``blocks_rows``); in each, g_t = y_t <w, x_t>
    against the block's starting w and the block's Gram G of the signed
    rows; rounds at the lowest step s whose row violates (p_t g_t < 1, p_t
    the product of the factors of the open steps before t's) or whose
    projection binds: with c = f_s p_s and V its violating rows,
    g <- c g + a_s sum_V G_r, |w|^2 <- c^2 |w|^2 + 2 c a_s sum_V g_r +
    a_s^2 sum_V sum_V G_rr', then the projection's scale on both; then the
    block's steps replayed on w in order (f w, coef times the sum over the
    violating rows in order, their sum, the scale, each rounded on its own)
    and |w|^2 recomputed from w. The step scalars are the reference's f32
    ones. Returns w (D,) in ``dtype``; ``flags`` gets each row's violation,
    ``projected`` (a list) the steps whose round projected. The tests hold
    it to the reference; the card holds the kernel to ``pegasos_scan_plain``."""
    _pegasos_args(X, y, lam, k, flags)
    if rows < k or rows % k:
        raise ValueError(f"rows={rows} must be whole steps of k={k}")
    n, d = X.shape
    dev = X.device
    factor, coef, radius = pegasos_scalars(lam, k, n // k)
    f = torch.as_tensor(factor, device=dev).to(dtype)
    a = torch.as_tensor(-coef, device=dev).to(dtype)
    R = float(radius)
    X, y = X.to(dtype), y.to(dtype)
    w = torch.zeros(d, dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    for r0 in range(0, n, rows):
        Xb, yb = X[r0:r0 + rows], y[r0:r0 + rows]
        m = yb.shape[0]
        S = m // k
        row = torch.arange(m, device=dev)
        steps = torch.arange(S, device=dev)
        sf, sa_ = f[r0 // k:r0 // k + S], a[r0 // k:r0 // k + S]
        Z = yb[:, None] * Xb
        G, g, wsq = Z @ Z.T, Z @ w, float(w.double() @ w.double())
        viol = torch.zeros(m, dtype=torch.bool, device=dev)
        scales = [None] * S
        s0 = 0
        while True:
            Q = torch.cumprod(torch.where(steps >= s0, sf, one), 0)
            P = torch.cat([one[None], Q[:-1]])
            c = sf * P
            v = (row >= s0 * k) & (P[row // k] * g < 1)
            nrm = torch.sqrt(c.double() ** 2 * wsq).to(dtype)
            bind = (steps >= s0) & (R / torch.clamp(nrm, min=1e-12) < 1)
            hit = [int(torch.nonzero(v)[0]) // k] if bool(v.any()) else []
            hit += [int(torch.nonzero(bind)[0])] if bool(bind.any()) else []
            if not hit:
                break
            st = min(hit)
            V = v & (row // k == st)
            cs, ak = c[st], sa_[st]
            u = G[V].sum(0)
            wsq = (float(cs) ** 2 * wsq + 2.0 * float(cs) * float(ak) * float(g[V].sum())
                   + float(ak) ** 2 * float(u[V].sum()))
            scale = min(one, R / torch.clamp(torch.sqrt(torch.tensor(wsq, dtype=dtype)),
                                             min=1e-12))
            g = scale * (cs * g + ak * u)
            wsq *= float(scale) ** 2
            scales[st] = scale
            viol |= V
            if projected is not None and scale < 1:
                projected.append(r0 // k + st)
            s0 = st + 1
        nv = torch.where(viol, -yb, torch.zeros_like(yb))
        for s in range(S):
            w = sf[s] * w
            rs = [s * k + i for i in range(k) if bool(viol[s * k + i])]
            if rs:
                acc = torch.zeros(d, dtype=dtype, device=dev)
                for r in rs:
                    acc = acc + nv[r] * Xb[r]
                w = w - sa_[s] * acc
            if scales[s] is not None and scales[s] != 1:
                w = w * scales[s]
        if flags is not None:
            flags[r0:r0 + m] = viol.to(torch.uint8)
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
    plan = pegasos_plan(X.shape[1], k, smem_budget=smem_budget, aligned=bool(_vec16(X)))
    _launch(plan, X, y, lam, k, w, flags)
    pegasos_scan.launches += 1
    by = pegasos_scan.layout_launches
    by[plan["layout"]] = by.get(plan["layout"], 0) + 1
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
    if plan["layout"] == "blocks":
        rb = plan["rows"]
        rp = -(-rb // 32) * 32
        G = torch.empty(-(-n // rb) * rp * rp, device=dev, dtype=torch.float32)
        err = _blocks_lib().pegasos_blocks(
            X.data_ptr(), y.data_ptr(), G.data_ptr(), w.data_ptr(), fptr, n, d, lam32, k, rb,
            _vec16(X), stream,
        )
        _build.check(err, "pegasos_blocks")
        return
    err = _pegasos_lib().pegasos_sweep(
        X.data_ptr(), y.data_ptr(), w.data_ptr(), fptr, n // k, k, d, lam32,
        int(plan["staged"]), _vec16(X), stream,
    )
    _build.check(err, "pegasos_sweep")


pegasos_scan.launches = 0  # kernel launches, read by chip_smoke.py
pegasos_scan.layout_launches = {}  # the same by layout
