"""The streaming kernels: one pass of Algorithm 1 or 2 over a stream.

B1  ``streamsvm_scan_many``: Algorithm 1 for a bank of B models over a
    shared stream. The port of the Algorithm-1 branch of the TPU kernel
    ``repro/kernels/streamsvm_scan.py::_block_update`` (driven by
    ``_kernel_many_tiled`` / ``streamsvm_scan_many_pallas``).
B3  ``streamsvm_scan_lookahead_many`` (``streamsvm_scan_many`` with
    ``lookahead=``): the fused Algorithm 2 for a bank, per-model L-row
    windows flushed farthest-first. The port of the lookahead branch of
    ``_block_update`` with ``_bank_flush``.
B4  ``streamsvm_scan``: Algorithm 1 for one model on label-signed rows, the
    port of ``_kernel`` / ``streamsvm_scan_pallas``, with B1's deferred
    update; its w row in shared memory where it fits (``single_plan``).
B6  ``streamsvm_scan_many_ring`` (and ``streamsvm_scan_lookahead_many_ring``):
    B1 and B3 for ``bank_resident="hbm"``, the port of ``_kernel_many_hbm``
    (``_call_many_hbm``): persistent CTAs that stage each stream chunk once
    for all their bank tiles, on B1's passes, with the tiles' whole rows in
    shared memory or their w chunks cycled through shared-memory slots
    (``ring_plan``). Equal to B1 / B3 bit for bit.

The kernels are CUDA C++ for Hopper, B1, B3 and B6 in
``csrc/streamsvm_scan.cu``, B4 in ``csrc/streamsvm_single.cu``; their headers
say how they are laid out and what bounds them. Each wrapper dispatches on the device of ``X``: a CPU
tensor runs its ``*_plain`` twin, the TPU kernel's blocked algorithm in
plain PyTorch; a CUDA tensor launches the kernel, or raises. They take the
padded stream ``ops`` prepares: N a multiple of ``block_n``, B a multiple of
8, sign-0 rows and rows at or past ``n_valid`` inert.

B1 and B3 launch in one of three layouts (``scan_plan``), all giving the
same bits: ``"resident"``, each CTA's bank tile in shared memory for the
whole launch and the stream copied ahead in chunks; ``"chunked"``, the
bank in device memory, staged column chunk by column chunk, where the tile
does not fit; and for B3 with few live models ``"small"``, one CTA for
each live model, its pushes and flushes spread over the CTA.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: Bank lanes per group. The plain version computes its per-block matrix
#: products over aligned groups of this many models, so a model's arithmetic
#: does not depend on how many models share its bank tile; the kernel's CTAs
#: hold the same number of models.
LANE_GROUP = 8

#: Rows per internal block of the kernels (``BN`` in csrc/streamsvm_scan.cu).
BLOCK_ROWS = 32
#: Shared memory one CTA may use on an H100: 227 KB, the per-block opt-in
#: limit (cudaDevAttrMaxSharedMemoryPerBlockOptin).
SMEM_PER_BLOCK = 232_448
#: Streaming multiprocessors of an H100 SXM.
H100_SMS = 132

#: Shared memory per CTA of the chunked layout (B1's ``scan_kernel`` and
#: B3's ``lookahead_kernel``), by term, as declared: the staged stream chunk
#: (32 x 129 f32), the bank chunk (8 x 129), the block Gram (32 x 33) and
#: per-model row state (B1's alpha*y, B3's flush masks: 8 x 32 words). It
#: does not grow with B or D: the bank stays in device memory.
SCAN_SMEM = {"stream_tile": 16_512, "bank_tile": 4_128, "block_gram": 4_224,
             "row_state": 1_024}
#: Columns of a staged stream chunk (``DC`` in csrc/streamsvm_scan.cu).
STREAM_DC = 128
#: Columns of a chunk of B6's lean layout (``RING_LEAN_DC``), the ring's
#: layout for budgets below the chunked kernels' bytes.
RING_LEAN_DC = 32
#: w slots of the ring's cycling layouts (``RING_SLOTS``): a step's, and two
#: steps copied ahead.
RING_SLOTS = 3
#: Most tiles one step of the cycling layout takes: one per warp pair.
RING_MAX_GROUP = 4
#: Threads of the small layout's CTA (``SMALL_THREADS``): 8 warps.
SMALL_THREADS = 256
#: Models per CTA the resident layout can take (its instantiations).
RESIDENT_MPC = (4, 8)
#: B3 takes the small layout (one CTA per live model) up to one live model
#: per SM, and a bank layout beyond. Measured on an H100 by
#: tools/scan_layouts.py (PERF.md): the small layout is the fastest at 1, 66
#: and 132 live models, the resident one at 600 (small 2.5x slower there).
SMALL_BANK_MAX_LIVE = H100_SMS

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("streamsvm_scan")
    lib.streamsvm_scan_many.argtypes = [_P] * 9 + [_I] * 5 + [_P]
    lib.streamsvm_scan_many.restype = ctypes.c_int
    lib.streamsvm_scan_lookahead.argtypes = [_P] * 11 + [_I] * 6 + [_P]
    lib.streamsvm_scan_lookahead.restype = ctypes.c_int
    lib.streamsvm_scan_ring.argtypes = [_P] * 11 + [_I] * 9 + [_P]
    lib.streamsvm_scan_ring.restype = ctypes.c_int
    lib.streamsvm_scan_ring_dyn_bytes.argtypes = [_I] * 5
    lib.streamsvm_scan_ring_dyn_bytes.restype = ctypes.c_long
    lib.streamsvm_scan_resident.argtypes = [_P] * 11 + [_I] * 8 + [_P]
    lib.streamsvm_scan_resident.restype = ctypes.c_int
    lib.streamsvm_scan_lookahead_small.argtypes = [_P] * 11 + [_I] * 8 + [_P]
    lib.streamsvm_scan_lookahead_small.restype = ctypes.c_int
    for fn in (lib.streamsvm_scan_resident_dyn_bytes, lib.streamsvm_scan_small_dyn_bytes):
        fn.argtypes = [_I] * 4
        fn.restype = ctypes.c_long
    return lib


def _wpitch(d: int) -> int:
    """A w row in shared memory: D rounded up to 8 floats."""
    return -(-d // 8) * 8


def _chunks_bytes(dtype, cols=STREAM_DC) -> int:
    """Two staged (32, cols) stream chunks, raw in the stream dtype, at a row
    pitch of cols plus one 16-byte copy."""
    es = 2 if dtype == torch.bfloat16 else 4
    return 2 * BLOCK_ROWS * (cols + 16 // es) * es


def resident_smem(d: int, mpc: int, *, lookahead: bool, dtype=torch.float32) -> dict:
    """Dynamic shared memory of the resident layout, bytes by term (it has
    no static bytes): two stream chunks, the (mpc, D) bank tile, the block
    Gram, h / alpha*y, then decay (B1) or the flush masks (B3)."""
    return {
        "stream_chunks": _chunks_bytes(dtype),
        "bank_tile": mpc * _wpitch(d) * 4,
        "block_gram": BLOCK_ROWS * BLOCK_ROWS * 4,
        "h_alpha": mpc * BLOCK_ROWS * 4,
        "row_state": mpc * (32 if lookahead else 1) * 4,
    }


def small_smem(d: int, lookahead_max: int, *, window_in_smem: bool, dtype=torch.float32) -> dict:
    """Dynamic shared memory of B3's small layout, bytes by term (no static
    bytes): two stream chunks, the model's w row, the block Gram, the row
    state (h / g corrections, the warps' farthest points, the window mask)
    and the window when it lives in shared memory."""
    return {
        "stream_chunks": _chunks_bytes(dtype),
        "w_row": _wpitch(d) * 4,
        "block_gram": BLOCK_ROWS * BLOCK_ROWS * 4,
        "row_state": (BLOCK_ROWS + 2 * (SMALL_THREADS // 32) + 32) * 4,
        "window": lookahead_max * _wpitch(d) * 4 if window_in_smem else 0,
    }


def scan_plan(
    bp: int, d: int, *, lookahead_max: int | None = None, n_live: int | None = None,
    dtype=torch.float32, smem_budget: int | None = None,
) -> dict:
    """The launch layout of B1 (``lookahead_max`` None) or B3 for ``bp``
    lanes (a multiple of LANE_GROUP) of D features, ``n_live`` of them live
    (default all; the rest padding), with a stream of ``dtype``.

    Each layout is held to ``smem_budget`` capped at the card's
    SMEM_PER_BLOCK (default the card's limit), as ``ring_plan`` is. B3 with
    at most SMALL_BANK_MAX_LIVE live models takes ``"small"`` (one CTA per
    live model; its window in shared memory where it fits, else in device
    memory) where the model's row fits. Otherwise ``"resident"`` with 8
    models per CTA, or 4 where 8 do not fit, else ``"chunked"`` (8 models
    per CTA, SCAN_SMEM whatever B and D: the budget's floor, below which
    ``ops`` refuses "vmem"). Every layout gives the same bits. Returns
    ``layout``, ``models_per_cta`` (1 in the small layout), ``ctas``,
    ``window`` ("smem" / "device", B3) and ``smem``, the shared memory per
    CTA by term (static for "chunked", dynamic for the other two)."""
    look = lookahead_max is not None
    live = bp if n_live is None else int(n_live)
    if not 1 <= live <= bp:
        raise ValueError(f"n_live must lie in [1, B={bp}]: got {n_live}")
    limit = SMEM_PER_BLOCK if smem_budget is None else min(int(smem_budget), SMEM_PER_BLOCK)
    fits = lambda terms: sum(terms.values()) <= limit
    window = "device" if look else None
    if look and live <= SMALL_BANK_MAX_LIVE:
        for in_smem in (True, False):
            smem = small_smem(d, lookahead_max, window_in_smem=in_smem, dtype=dtype)
            if fits(smem):
                return dict(layout="small", models_per_cta=1, ctas=live,
                            window="smem" if in_smem else "device", smem=smem)
    for mpc in RESIDENT_MPC[::-1]:
        smem = resident_smem(d, mpc, lookahead=look, dtype=dtype)
        if bp % mpc == 0 and fits(smem):
            return dict(layout="resident", models_per_cta=mpc, ctas=bp // mpc, window=window,
                        smem=smem)
    return dict(layout="chunked", models_per_cta=LANE_GROUP, ctas=bp // LANE_GROUP,
                window=window, smem=dict(SCAN_SMEM))


def _vec16(X: torch.Tensor) -> int:
    """1 when every row of X starts on a 16-byte boundary (the kernels then
    copy the stream with 16-byte cp.async), else 0."""
    return int(X.data_ptr() % 16 == 0 and X.shape[1] * X.element_size() % 16 == 0)


def _single_lib() -> ctypes.CDLL:
    lib = _build.load("streamsvm_single")
    lib.streamsvm_single.argtypes = [_P] * 6 + [_I] * 6 + [_P]
    lib.streamsvm_single.restype = ctypes.c_int
    lib.streamsvm_single_dyn_bytes.argtypes = [_I] * 3
    lib.streamsvm_single_dyn_bytes.restype = ctypes.c_long
    return lib


#: Columns of B4's staged stream chunk where no whole 32-row block fits
#: (``SDC`` in csrc/streamsvm_single.cu).
SINGLE_DC = 256


def single_smem(d: int, *, w_in_smem: bool, chunk: int = SINGLE_DC) -> dict:
    """Dynamic shared memory of B4, bytes by term (it has no static bytes):
    two f32 stream chunks of ``chunk`` columns at a pitch of 4 more, the
    block Gram, h and alpha*y, the chunks' two mbarriers (16 B), and the w
    row when it lives there."""
    return {
        "stream_chunks": 2 * BLOCK_ROWS * (chunk + 4) * 4,
        "block_gram": BLOCK_ROWS * BLOCK_ROWS * 4,
        "row_state": 2 * BLOCK_ROWS * 4,
        "mbarriers": 16,
        "w_row": _wpitch(d) * 4 if w_in_smem else 0,
    }


def single_plan(d: int) -> dict:
    """B4's layout at D features, the first that fits the card's
    SMEM_PER_BLOCK: whole 32-row blocks (``chunk`` = D rounded up to 4, one
    copy a block, a block ahead) with the w row in shared memory, else
    SINGLE_DC-column chunks with the w row in shared memory, else with w in
    device memory (any D). Returns ``chunk``, ``w_in_smem`` and ``smem``."""
    for chunk, ws in ((-(-d // 4) * 4, True), (SINGLE_DC, True), (SINGLE_DC, False)):
        smem = single_smem(d, w_in_smem=ws, chunk=chunk)
        if sum(smem.values()) <= SMEM_PER_BLOCK:
            return dict(chunk=chunk, w_in_smem=ws, smem=smem)
    raise AssertionError("unreachable: the last layout does not grow with D")


def _check_args(X, Y, W0, r0, xi20, c_inv, m0, gain, block_n):
    n, d = X.shape
    bp = Y.shape[0]
    if Y.shape != (bp, n):
        raise ValueError(
            f"Y must be (B, N) sign rows matching X: got Y.shape={tuple(Y.shape)}, "
            f"X.shape={tuple(X.shape)}"
        )
    if W0.shape != (bp, d):
        raise ValueError(f"W0 must be (B, D)=({bp}, {d}): got {tuple(W0.shape)}")
    for name, v in (("r0", r0), ("xi20", xi20), ("c_inv", c_inv), ("m0", m0), ("gain", gain)):
        if v.shape != (bp,):
            raise ValueError(f"{name} must be (B,)=({bp},): got {tuple(v.shape)}")
    if n % block_n != 0:
        raise ValueError(
            f"N={n} must be a multiple of block_n={block_n} (pad the stream; "
            "ops.streamsvm_fit_many does this)"
        )
    if bp % LANE_GROUP != 0:
        raise ValueError(
            f"B={bp} must be a multiple of {LANE_GROUP} (pad the bank; "
            "ops.streamsvm_fit_many does this)"
        )


def _grouped(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` computed over aligned groups of LANE_GROUP rows of ``a``."""
    return torch.cat([a[i : i + LANE_GROUP] @ b for i in range(0, a.shape[0], LANE_GROUP)])


def streamsvm_scan_many_plain(X, Y, W0, r0, xi20, c_inv, m0, gain, *, n_valid, block_n=256):
    """Plain PyTorch version of B1: the TPU kernel's blocked algorithm.

    Per block of ``block_n`` rows: the block Gram, ``g = ys * (W X^T)``, the
    row-by-row update of every model at once, and the deferred
    ``W <- decay * W + (alpha * ys) X``. Returns ``(W, r, xi2, m)``.
    """
    _check_args(X, Y, W0, r0, xi20, c_inv, m0, gain, block_n)
    torch.backends.cuda.matmul.allow_tf32 = False  # TF32 flips d >= r decisions
    n = min(int(n_valid), X.shape[0])
    w = W0.float().clone()
    r, xi2 = r0.float().clone(), xi20.float().clone()
    c_inv, gain = c_inv.float(), gain.float()
    m = m0.to(torch.int32).clone()
    wsq = (w * w).sum(1)
    for i0 in range(0, n, block_n):
        x = X[i0 : i0 + block_n].float()  # bf16 tiles upcast here
        ys = Y[:, i0 : i0 + block_n].float()
        w, r, xi2, m, wsq = _scan_block_plain(
            x, ys, x @ x.T, w, r, xi2, c_inv, gain, m, wsq, min(block_n, n - i0)
        )
    return w, r, xi2, m


def _scan_block_plain(x, ys, gram, w, r, xi2, c_inv, gain, m, wsq, rows):
    """One block of B1's plain version for the models of ``w`` (a whole
    number of lane groups): ``g = ys * (W X^T)``, the row-by-row update of
    every model at once over the first ``rows`` rows, and the deferred
    ``W <- decay * W + (alpha * ys) X``. Returns ``(w, r, xi2, m, wsq)``."""
    g = ys * _grouped(w, x.T)
    alpha = torch.zeros_like(g)
    decay = torch.ones_like(r)
    # Rows at or past n_valid leave every quantity exactly as it is (s = 0),
    # so the loop stops at the last valid row.
    for jr in range(rows):
        gj = g[:, jr]
        gjj = gram[jr, jr]
        d = torch.sqrt(torch.clamp(wsq - 2.0 * gj + gjj + xi2 + c_inv, min=1e-12))
        yj = ys[:, jr]
        upd = (d >= r) & (yj != 0.0)
        s = torch.where(upd, 0.5 * (1.0 - r / d), 0.0)
        one_s = 1.0 - s
        g = one_s[:, None] * g + (s * yj)[:, None] * (ys * gram[jr][None, :])
        alpha = one_s[:, None] * alpha
        alpha[:, jr] = s
        decay = decay * one_s
        wsq = one_s**2 * wsq + 2.0 * s * one_s * gj + s**2 * gjj
        r = torch.where(upd, r + 0.5 * (d - r), r)
        xi2 = xi2 * one_s**2 + s**2 * gain
        m = m + upd.to(torch.int32)
    w = decay[:, None] * w + _grouped(alpha * ys, x)
    return w, r, xi2, m, wsq


def streamsvm_scan_many(
    X, Y, W0, r0, xi20, c_inv, m0, gain, *, n_valid, block_n=256, lookahead=None,
    lookahead_max=None, n_live=None, smem_budget=None,
):
    """B1 on the device of ``X``: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. Returns ``(W, r, xi2, m)``.

    X: (N, D) f32 or bf16 stream; Y: (B, N) signs of the same dtype; W0:
    (B, D) f32; r0, xi20, c_inv, gain: (B,) f32; m0: (B,) int32. With
    ``lookahead`` ((B,) int32 windows) and ``lookahead_max`` (their largest)
    it runs Algorithm 2 through B3 (``streamsvm_scan_lookahead_many``, which
    reads ``n_live``). ``smem_budget``: the shared memory a CTA may take
    (``scan_plan``; default the card's limit); every layout gives the same
    bits.
    """
    if lookahead is not None:
        return streamsvm_scan_lookahead_many(
            X, Y, W0, r0, xi20, c_inv, m0, gain, lookahead=lookahead,
            lookahead_max=lookahead_max, n_valid=n_valid, block_n=block_n, n_live=n_live,
            smem_budget=smem_budget,
        )
    if X.device.type == "cpu":
        return streamsvm_scan_many_plain(
            X, Y, W0, r0, xi20, c_inv, m0, gain, n_valid=n_valid, block_n=block_n
        )
    if X.device.type != "cuda":
        raise ValueError(f"streamsvm_scan_many runs on cuda or cpu, not {X.device}")
    _check_args(X, Y, W0, r0, xi20, c_inv, m0, gain, block_n)
    if X.dtype not in (torch.float32, torch.bfloat16) or Y.dtype != X.dtype:
        raise ValueError(
            f"X and Y must share a float32 or bfloat16 stream dtype: got {X.dtype}, {Y.dtype}"
        )
    dev = X.device
    n, d = X.shape
    bp = Y.shape[0]
    X, Y = X.contiguous(), Y.contiguous()
    W = W0.to(dev, torch.float32).contiguous().clone()
    r = r0.to(dev, torch.float32).contiguous().clone()
    xi2 = xi20.to(dev, torch.float32).contiguous().clone()
    m = m0.to(dev, torch.int32).contiguous().clone()
    c_inv = c_inv.to(dev, torch.float32).contiguous()
    gain = gain.to(dev, torch.float32).contiguous()
    plan = scan_plan(bp, d, dtype=X.dtype, smem_budget=smem_budget)
    lib = _lib()
    bn = lib.streamsvm_scan_block_rows()
    G = torch.empty(((n + bn - 1) // bn) * bn * bn, device=dev, dtype=torch.float32)
    ptrs = (X.data_ptr(), Y.data_ptr(), G.data_ptr(), W.data_ptr(), r.data_ptr(),
            xi2.data_ptr(), m.data_ptr(), c_inv.data_ptr(), gain.data_ptr())
    bf16, stream = int(X.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream
    if plan["layout"] == "resident":
        err = lib.streamsvm_scan_resident(
            *ptrs, None, None, n, int(n_valid), d, bp, 0, plan["models_per_cta"], _vec16(X),
            bf16, stream,
        )
    else:
        err = lib.streamsvm_scan_many(*ptrs, n, int(n_valid), d, bp, bf16, stream)
    _build.check(err, f"streamsvm_scan_many ({plan['layout']})")
    streamsvm_scan_many.launches += 1
    return W, r, xi2, m


streamsvm_scan_many.launches = 0  # kernel launches, read by chip_smoke.py


# ---------------------------------------------------------------------------
# B3: the fused Algorithm 2 for a bank
# ---------------------------------------------------------------------------


def _check_lookahead(lookahead, lookahead_max, bp):
    if lookahead is None or lookahead_max is None:
        raise ValueError(
            "lookahead (per-model windows) and lookahead_max (their largest) "
            f"must be passed together: got {lookahead=}, {lookahead_max=}"
        )
    if lookahead.shape != (bp,):
        raise ValueError(f"lookahead must be (B,)=({bp},): got {tuple(lookahead.shape)}")
    if lookahead_max < 1:
        raise ValueError(f"lookahead_max must be >= 1: got {lookahead_max}")


def _bank_flush_plain(w, r, xi2, g, cnt, buf, fmask, x, ys, c_inv, gain):
    """Farthest-first flush of the windows of the models in ``fmask``
    (``_bank_flush``): up to L_max steps, each absorbing every flushing
    model's farthest remaining point if it lies on or outside the ball and
    else dropping the model's whole window; ``g`` (``<w, y_k x_k>`` for the
    block) is corrected through one grouped product per step. Returns
    ``(w, r, xi2, g)``."""
    bp, l_max, _ = buf.shape
    slot = torch.arange(l_max, device=buf.device)
    lanes = torch.arange(bp, device=buf.device)
    remain = (slot[None, :] < cnt[:, None]) & fmask[:, None]
    for _ in range(l_max):
        if not bool(remain.any()):
            break  # the remaining steps would change nothing (s = 0)
        bd2 = ((w[:, None, :] - buf) ** 2).sum(-1) + xi2[:, None] + c_inv[:, None]
        bdm = torch.where(remain, torch.sqrt(torch.clamp(bd2, min=1e-12)), -torch.inf)
        far = torch.argmax(bdm, dim=1)  # the first maximum: lowest slot on ties
        dfar = bdm[lanes, far]
        has = remain.any(1)
        act = has & (dfar >= r)
        s = torch.where(act, 0.5 * (1.0 - r / torch.where(act, dfar, 1.0)), 0.0)
        one_s = 1.0 - s
        pfar = torch.where(has[:, None], buf[lanes, far], 0.0)
        w = one_s[:, None] * w + s[:, None] * pfar
        r = torch.where(act, r + 0.5 * (dfar - r), r)
        xi2 = xi2 * one_s**2 + s**2 * gain
        g = one_s[:, None] * g + s[:, None] * (ys * _grouped(pfar, x.T))
        # Remove the absorbed slot; if the farthest point was enclosed, every
        # remaining point is too: drop the whole window.
        sel = slot[None, :] == far[:, None]
        remain = remain & ~(sel & act[:, None]) & ~(has & ~act)[:, None]
    return w, r, xi2, g


def streamsvm_scan_lookahead_many_plain(
    X, Y, W0, r0, xi20, c_inv, m0, gain, *, lookahead, lookahead_max, n_valid, block_n=256
):
    """Plain PyTorch version of B3: the lookahead branch of the TPU kernel's
    ``_block_update``.

    Per block: the block Gram and ``g = ys * (W X^T)``; then, row by row, a
    row that violates model b (Gram-form d >= r, sign != 0) is pushed as
    ``y_bj x_j`` into slot ``cnt_b`` of b's window and counted in ``m``; a
    window holding ``lookahead[b]`` rows is flushed (``_bank_flush_plain``)
    and ``|w|^2`` recomputed. The partial windows are flushed after the
    last row. Returns ``(W, r, xi2, m)``.
    """
    _check_args(X, Y, W0, r0, xi20, c_inv, m0, gain, block_n)
    bp, d = W0.shape
    _check_lookahead(lookahead, lookahead_max, bp)
    torch.backends.cuda.matmul.allow_tf32 = False  # TF32 flips d >= r decisions
    n = min(int(n_valid), X.shape[0])
    w = W0.float().clone()
    r, xi2 = r0.float().clone(), xi20.float().clone()
    c_inv, gain = c_inv.float(), gain.float()
    m = m0.to(torch.int32).clone()
    L = lookahead.to(torch.int32)
    wsq = (w * w).sum(1)
    buf = torch.zeros((bp, lookahead_max, d), dtype=torch.float32, device=w.device)
    cnt = torch.zeros((bp,), dtype=torch.int32, device=w.device)
    x = ys = g = None
    for i0 in range(0, n, block_n):
        x = X[i0 : i0 + block_n].float()  # bf16 tiles upcast here
        ys = Y[:, i0 : i0 + block_n].float()
        w, r, xi2, m, wsq, cnt, g = _lookahead_block_plain(
            x, ys, x @ x.T, w, r, xi2, c_inv, gain, m, wsq, L, buf, cnt, min(block_n, n - i0)
        )
    if x is not None and bool((cnt > 0).any()):  # the partial windows
        w, r, xi2, _ = _bank_flush_plain(w, r, xi2, g, cnt, buf, cnt > 0, x, ys, c_inv, gain)
    return w, r, xi2, m


def _lookahead_block_plain(x, ys, gram, w, r, xi2, c_inv, gain, m, wsq, L, buf, cnt, rows):
    """One block of B3's plain version for the models of ``w`` (a whole
    number of lane groups) and their windows ``buf`` (written in place).
    Returns ``(w, r, xi2, m, wsq, cnt, g)``."""
    g = ys * _grouped(w, x.T)
    for jr in range(rows):
        gj = g[:, jr]
        d = torch.sqrt(torch.clamp(wsq - 2.0 * gj + gram[jr, jr] + xi2 + c_inv, min=1e-12))
        yj = ys[:, jr]
        violate = (d >= r) & (yj != 0.0)
        if not bool(violate.any()):
            continue  # nothing is pushed, so no window fills
        hit = violate.nonzero()[:, 0]
        buf[hit, cnt[hit].long()] = yj[hit, None] * x[jr][None, :]
        cnt = cnt + violate.to(torch.int32)
        m = m + violate.to(torch.int32)  # counted at push
        full = cnt >= L
        if bool(full.any()):
            w, r, xi2, g = _bank_flush_plain(w, r, xi2, g, cnt, buf, full, x, ys, c_inv, gain)
            cnt = torch.where(full, 0, cnt)
            wsq = (w * w).sum(1)  # w only changes in a flush
    return w, r, xi2, m, wsq, cnt, g


def streamsvm_scan_lookahead_many(
    X, Y, W0, r0, xi20, c_inv, m0, gain, *, lookahead, lookahead_max, n_valid, block_n=256,
    n_live=None, smem_budget=None,
):
    """B3 on the device of ``X``: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. Returns ``(W, r, xi2, m)``.

    Arguments as ``streamsvm_scan_many``, plus ``lookahead``: (B,) int32
    per-model windows (padded lanes 1), and ``lookahead_max``, their largest.
    ``n_live``: the live models, the first of the B lanes (default all); the
    lanes past it must be padding (r = +inf, sign 0, L = 1), which the small
    layout leaves as they are. ``smem_budget``: as ``streamsvm_scan_many``.
    """
    if X.device.type == "cpu":
        return streamsvm_scan_lookahead_many_plain(
            X, Y, W0, r0, xi20, c_inv, m0, gain, lookahead=lookahead,
            lookahead_max=lookahead_max, n_valid=n_valid, block_n=block_n,
        )
    if X.device.type != "cuda":
        raise ValueError(f"streamsvm_scan_lookahead_many runs on cuda or cpu, not {X.device}")
    _check_args(X, Y, W0, r0, xi20, c_inv, m0, gain, block_n)
    bp, d = W0.shape
    _check_lookahead(lookahead, lookahead_max, bp)
    if X.dtype not in (torch.float32, torch.bfloat16) or Y.dtype != X.dtype:
        raise ValueError(
            f"X and Y must share a float32 or bfloat16 stream dtype: got {X.dtype}, {Y.dtype}"
        )
    lib = _lib()
    if lookahead_max > lib.streamsvm_scan_lookahead_max():
        raise ValueError(
            f"lookahead_max={lookahead_max}: B3 takes windows of at most "
            f"{lib.streamsvm_scan_lookahead_max()} rows"
        )
    dev = X.device
    L = lookahead.to(dev, torch.int32).contiguous()
    if int(L.max()) > lookahead_max or int(L.min()) < 1:
        raise ValueError(f"every lookahead must lie in [1, lookahead_max={lookahead_max}]")
    n = X.shape[0]
    X, Y = X.contiguous(), Y.contiguous()
    W = W0.to(dev, torch.float32).contiguous().clone()
    r = r0.to(dev, torch.float32).contiguous().clone()
    xi2 = xi20.to(dev, torch.float32).contiguous().clone()
    m = m0.to(dev, torch.int32).contiguous().clone()
    c_inv = c_inv.to(dev, torch.float32).contiguous()
    gain = gain.to(dev, torch.float32).contiguous()
    plan = scan_plan(bp, d, lookahead_max=int(lookahead_max), n_live=n_live, dtype=X.dtype,
                     smem_budget=smem_budget)
    bn = lib.streamsvm_scan_block_rows()
    G = torch.empty(((n + bn - 1) // bn) * bn * bn, device=dev, dtype=torch.float32)
    in_smem = plan["window"] == "smem"
    buf = torch.empty(0 if in_smem else bp * lookahead_max * d, device=dev, dtype=torch.float32)
    ptrs = (X.data_ptr(), Y.data_ptr(), G.data_ptr(), W.data_ptr(), r.data_ptr(),
            xi2.data_ptr(), m.data_ptr(), c_inv.data_ptr(), gain.data_ptr(), L.data_ptr(),
            buf.data_ptr())
    bf16, stream = int(X.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream
    if plan["layout"] == "small":
        err = lib.streamsvm_scan_lookahead_small(
            *ptrs, n, int(n_valid), d, plan["ctas"], int(lookahead_max), int(in_smem),
            _vec16(X), bf16, stream,
        )
    elif plan["layout"] == "resident":
        err = lib.streamsvm_scan_resident(
            *ptrs, n, int(n_valid), d, bp, int(lookahead_max), plan["models_per_cta"],
            _vec16(X), bf16, stream,
        )
    else:
        err = lib.streamsvm_scan_lookahead(*ptrs, n, int(n_valid), d, bp, int(lookahead_max),
                                           bf16, stream)
    _build.check(err, f"streamsvm_scan_lookahead ({plan['layout']})")
    streamsvm_scan_lookahead_many.launches += 1
    return W, r, xi2, m


streamsvm_scan_lookahead_many.launches = 0  # kernel launches, read by chip_smoke.py


# ---------------------------------------------------------------------------
# B6 train: B1 and B3 through the ring (bank_resident="hbm")
# ---------------------------------------------------------------------------


def sm_count() -> int:
    """Streaming multiprocessors of the current CUDA card; an H100's 132
    where there is none (the byte models then describe the card the port
    targets)."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    return H100_SMS


def ring_group(layout: str, jmax: int) -> int:
    """Tiles one step of B6's ring takes (``ring_group`` in csrc): every
    tile when they are owned, up to RING_MAX_GROUP (one per warp pair) in
    the cycling layout, one in the lean layout."""
    return {"owned": jmax, "cycling": min(jmax, RING_MAX_GROUP), "lean": 1}[layout]


def ring_smem(d: int, jmax: int, layout: str, *, lookahead: bool, dtype=torch.float32) -> dict:
    """Dynamic shared memory of B6's ring, bytes by term (it has no static
    bytes), for ``jmax`` tiles per CTA: two stream chunks (32 columns in the
    lean layout, else STREAM_DC), the block Gram, the bank (``"owned"``:
    jmax tiles' whole rows; ``"cycling"``: RING_SLOTS slots of ``ring_group``
    tiles' chunks, rows padded by a 16-byte copy; ``"lean"``: RING_SLOTS
    slots of one tile's 32-column chunks), h / alpha*y and six scalars per
    model, then (lookahead) the flush masks."""
    lean = layout == "lean"
    cols = RING_LEAN_DC if lean else STREAM_DC
    if layout == "owned":
        bank = jmax * LANE_GROUP * _wpitch(d)
    else:
        bank = RING_SLOTS * ring_group(layout, jmax) * LANE_GROUP * (cols if lean else cols + 4)
    return {
        "stream_chunks": _chunks_bytes(dtype, cols),
        "block_gram": BLOCK_ROWS * BLOCK_ROWS * 4,
        "bank": bank * 4,
        "h_alpha": jmax * LANE_GROUP * BLOCK_ROWS * 4,
        "state": jmax * LANE_GROUP * 6 * 4,  # r, xi2, |w|^2, decay, m, cnt
        "window_masks": LANE_GROUP * 32 * 4 if lookahead else 0,
    }


def ring_plan(
    bp: int, d: int, *, lookahead: bool, n_ctas: int | None = None, dtype=torch.float32,
    smem_budget: int | None = None,
) -> dict:
    """B6's launch layout for ``bp`` lanes of D features and a stream of
    ``dtype``: ``n_ctas`` persistent CTAs (default: one per SM, at most one
    per tile of LANE_GROUP models), ``jmax`` tiles on the busiest one, and
    the first layout that fits ``smem_budget`` (capped at the card's
    SMEM_PER_BLOCK): ``"owned"`` (at most 2 tiles per CTA, their whole rows
    in shared memory), ``"cycling"`` (the w chunks copied through slots,
    ``group`` = ``ring_group`` tiles a step) or ``"lean"`` (32-column
    chunks, one tile a step: at most 16,640 + 1,216 jmax bytes, 1,024 more
    with lookahead, for budgets below the chunked kernels'); the lean
    layout where none fits (the preflight then refuses it). Returns
    ``n_ctas``, ``jmax``, ``layout``, ``group`` and ``smem``
    (``ring_smem``). Every layout gives the same bits."""
    tiles = bp // LANE_GROUP
    n_ctas = min(tiles, sm_count()) if n_ctas is None else int(n_ctas)
    if not 1 <= n_ctas <= tiles:
        raise ValueError(f"n_ctas must lie in [1, {tiles}] for {tiles} tiles: got {n_ctas}")
    jmax = -(-tiles // n_ctas)
    limit = SMEM_PER_BLOCK if smem_budget is None else min(int(smem_budget), SMEM_PER_BLOCK)
    for layout in (("owned",) if jmax <= 2 else ()) + ("cycling", "lean"):
        smem = ring_smem(d, jmax, layout, lookahead=lookahead, dtype=dtype)
        if sum(smem.values()) <= limit:
            break
    return dict(n_ctas=n_ctas, jmax=jmax, layout=layout, group=ring_group(layout, jmax),
                smem=smem)


_RING_LAYOUTS = {"owned": 0, "cycling": 1, "lean": 2}  # as csrc/streamsvm_scan.cu numbers them


def _ring_tiles(bp, ring_tile, n_ctas):
    """The plain ring's tiles: ``ring_tile`` models each (a multiple of
    LANE_GROUP dividing B), dealt to ``n_ctas`` CTAs (default 1) as the
    kernel deals them: tile c + j n_ctas to CTA c. Returns a slice list per
    CTA."""
    if ring_tile % LANE_GROUP or bp % ring_tile:
        raise ValueError(
            f"ring_tile={ring_tile} must be a multiple of {LANE_GROUP} dividing B={bp}"
        )
    tiles = bp // ring_tile
    n_ctas = 1 if n_ctas is None else int(n_ctas)
    if not 1 <= n_ctas <= tiles:
        raise ValueError(f"n_ctas must lie in [1, {tiles}] for {tiles} tiles: got {n_ctas}")
    return [
        [slice(t * ring_tile, (t + 1) * ring_tile) for t in range(c, tiles, n_ctas)]
        for c in range(n_ctas)
    ]


def streamsvm_scan_many_ring_plain(
    X, Y, W0, r0, xi20, c_inv, m0, gain, *, n_valid, block_n=256, ring_tile=LANE_GROUP,
    n_ctas=None,
):
    """Plain PyTorch version of B6 train, Algorithm 1: B1's plain version in
    the ring's data-major order. Each CTA takes its tiles (``_ring_tiles``)
    through the stream, blocks outer and tiles inner, each tile's state
    carried between its visits. Equal to ``streamsvm_scan_many_plain`` bit
    for bit whatever ``ring_tile`` and ``n_ctas``. Returns ``(W, r, xi2, m)``."""
    _check_args(X, Y, W0, r0, xi20, c_inv, m0, gain, block_n)
    ctas = _ring_tiles(W0.shape[0], ring_tile, n_ctas)
    torch.backends.cuda.matmul.allow_tf32 = False  # TF32 flips d >= r decisions
    n = min(int(n_valid), X.shape[0])
    w = W0.float().clone()
    r, xi2 = r0.float().clone(), xi20.float().clone()
    c_inv, gain = c_inv.float(), gain.float()
    m = m0.to(torch.int32).clone()
    wsq = (w * w).sum(1)
    for own in ctas:
        for i0 in range(0, n, block_n):
            x = X[i0 : i0 + block_n].float()  # bf16 tiles upcast here
            gram = x @ x.T
            for sl in own:
                w[sl], r[sl], xi2[sl], m[sl], wsq[sl] = _scan_block_plain(
                    x, Y[sl, i0 : i0 + block_n].float(), gram, w[sl], r[sl], xi2[sl],
                    c_inv[sl], gain[sl], m[sl], wsq[sl], min(block_n, n - i0),
                )
    return w, r, xi2, m


def streamsvm_scan_lookahead_many_ring_plain(
    X, Y, W0, r0, xi20, c_inv, m0, gain, *, lookahead, lookahead_max, n_valid, block_n=256,
    ring_tile=LANE_GROUP, n_ctas=None,
):
    """Plain PyTorch version of B6 train, Algorithm 2: B3's plain version in
    the ring's data-major order, each tile's windows and counts carried
    between its visits and its partial windows flushed after the last row.
    Equal to ``streamsvm_scan_lookahead_many_plain`` bit for bit whatever
    ``ring_tile`` and ``n_ctas``. Returns ``(W, r, xi2, m)``."""
    _check_args(X, Y, W0, r0, xi20, c_inv, m0, gain, block_n)
    bp, d = W0.shape
    _check_lookahead(lookahead, lookahead_max, bp)
    ctas = _ring_tiles(bp, ring_tile, n_ctas)
    torch.backends.cuda.matmul.allow_tf32 = False  # TF32 flips d >= r decisions
    n = min(int(n_valid), X.shape[0])
    w = W0.float().clone()
    r, xi2 = r0.float().clone(), xi20.float().clone()
    c_inv, gain = c_inv.float(), gain.float()
    m = m0.to(torch.int32).clone()
    L = lookahead.to(torch.int32)
    wsq = (w * w).sum(1)
    buf = torch.zeros((bp, lookahead_max, d), dtype=torch.float32, device=w.device)
    cnt = torch.zeros((bp,), dtype=torch.int32, device=w.device)
    for own in ctas:
        x = None
        last = {}  # per tile: the last block's (ys, g) for the final flush
        for i0 in range(0, n, block_n):
            x = X[i0 : i0 + block_n].float()
            gram = x @ x.T
            for k, sl in enumerate(own):
                ys = Y[sl, i0 : i0 + block_n].float()
                w[sl], r[sl], xi2[sl], m[sl], wsq[sl], cnt[sl], g = _lookahead_block_plain(
                    x, ys, gram, w[sl], r[sl], xi2[sl], c_inv[sl], gain[sl], m[sl], wsq[sl],
                    L[sl], buf[sl], cnt[sl], min(block_n, n - i0),
                )
                last[k] = (ys, g)
        for k, sl in enumerate(own):
            if x is not None and bool((cnt[sl] > 0).any()):  # the partial windows
                ys, g = last[k]
                w[sl], r[sl], xi2[sl], _ = _bank_flush_plain(
                    w[sl], r[sl], xi2[sl], g, cnt[sl], buf[sl], cnt[sl] > 0, x, ys,
                    c_inv[sl], gain[sl],
                )
    return w, r, xi2, m


def _ring_state(W0, r0, xi20, c_inv, m0, gain, dev):
    return (
        W0.to(dev, torch.float32).contiguous().clone(),
        r0.to(dev, torch.float32).contiguous().clone(),
        xi20.to(dev, torch.float32).contiguous().clone(),
        m0.to(dev, torch.int32).contiguous().clone(),
        c_inv.to(dev, torch.float32).contiguous(),
        gain.to(dev, torch.float32).contiguous(),
    )


def streamsvm_scan_many_ring(
    X, Y, W0, r0, xi20, c_inv, m0, gain, *, n_valid, block_n=256, lookahead=None,
    lookahead_max=None, n_ctas=None, smem_budget=None,
):
    """B6 train on the device of ``X``: the ring kernel for a CUDA tensor,
    the plain version for a CPU tensor. Arguments and result as
    ``streamsvm_scan_many`` (with ``lookahead`` it runs Algorithm 2,
    ``streamsvm_scan_lookahead_many_ring``). ``n_ctas``: the persistent
    CTAs (default one per SM, see ``ring_plan``), which sets the tiles each
    walks the stream with; ``smem_budget``: the shared memory per CTA the
    layout may take (``ring_plan``). Neither changes a bit of the result."""
    if lookahead is not None:
        return streamsvm_scan_lookahead_many_ring(
            X, Y, W0, r0, xi20, c_inv, m0, gain, lookahead=lookahead,
            lookahead_max=lookahead_max, n_valid=n_valid, block_n=block_n, n_ctas=n_ctas,
            smem_budget=smem_budget,
        )
    if X.device.type == "cpu":
        return streamsvm_scan_many_ring_plain(
            X, Y, W0, r0, xi20, c_inv, m0, gain, n_valid=n_valid, block_n=block_n,
            n_ctas=n_ctas,
        )
    if X.device.type != "cuda":
        raise ValueError(f"streamsvm_scan_many_ring runs on cuda or cpu, not {X.device}")
    _check_args(X, Y, W0, r0, xi20, c_inv, m0, gain, block_n)
    if X.dtype not in (torch.float32, torch.bfloat16) or Y.dtype != X.dtype:
        raise ValueError(
            f"X and Y must share a float32 or bfloat16 stream dtype: got {X.dtype}, {Y.dtype}"
        )
    dev = X.device
    n, d = X.shape
    bp = Y.shape[0]
    plan = ring_plan(bp, d, lookahead=False, n_ctas=n_ctas, dtype=X.dtype,
                     smem_budget=smem_budget)
    X, Y = X.contiguous(), Y.contiguous()
    W, r, xi2, m, c_inv, gain = _ring_state(W0, r0, xi20, c_inv, m0, gain, dev)
    G = torch.empty(-(-n // BLOCK_ROWS) * BLOCK_ROWS * BLOCK_ROWS, device=dev,
                    dtype=torch.float32)
    err = _lib().streamsvm_scan_ring(
        X.data_ptr(), Y.data_ptr(), G.data_ptr(), W.data_ptr(), r.data_ptr(), xi2.data_ptr(),
        m.data_ptr(), c_inv.data_ptr(), gain.data_ptr(), None, None, n, int(n_valid), d, bp,
        0, plan["n_ctas"], _RING_LAYOUTS[plan["layout"]], _vec16(X),
        int(X.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "streamsvm_scan_ring")
    streamsvm_scan_many_ring.launches += 1
    return W, r, xi2, m


streamsvm_scan_many_ring.launches = 0  # kernel launches, read by chip_smoke.py


def streamsvm_scan_lookahead_many_ring(
    X, Y, W0, r0, xi20, c_inv, m0, gain, *, lookahead, lookahead_max, n_valid, block_n=256,
    n_ctas=None, smem_budget=None,
):
    """B6 train, Algorithm 2, on the device of ``X``: the ring kernel for a
    CUDA tensor, the plain version for a CPU tensor. Arguments and result as
    ``streamsvm_scan_lookahead_many``, plus ``n_ctas`` and ``smem_budget``
    as in ``streamsvm_scan_many_ring``."""
    if X.device.type == "cpu":
        return streamsvm_scan_lookahead_many_ring_plain(
            X, Y, W0, r0, xi20, c_inv, m0, gain, lookahead=lookahead,
            lookahead_max=lookahead_max, n_valid=n_valid, block_n=block_n, n_ctas=n_ctas,
        )
    if X.device.type != "cuda":
        raise ValueError(
            f"streamsvm_scan_lookahead_many_ring runs on cuda or cpu, not {X.device}"
        )
    _check_args(X, Y, W0, r0, xi20, c_inv, m0, gain, block_n)
    bp, d = W0.shape
    _check_lookahead(lookahead, lookahead_max, bp)
    if X.dtype not in (torch.float32, torch.bfloat16) or Y.dtype != X.dtype:
        raise ValueError(
            f"X and Y must share a float32 or bfloat16 stream dtype: got {X.dtype}, {Y.dtype}"
        )
    lib = _lib()
    if lookahead_max > lib.streamsvm_scan_lookahead_max():
        raise ValueError(
            f"lookahead_max={lookahead_max}: B6 takes windows of at most "
            f"{lib.streamsvm_scan_lookahead_max()} rows"
        )
    dev = X.device
    L = lookahead.to(dev, torch.int32).contiguous()
    if int(L.max()) > lookahead_max or int(L.min()) < 1:
        raise ValueError(f"every lookahead must lie in [1, lookahead_max={lookahead_max}]")
    n = X.shape[0]
    plan = ring_plan(bp, d, lookahead=True, n_ctas=n_ctas, dtype=X.dtype,
                     smem_budget=smem_budget)
    X, Y = X.contiguous(), Y.contiguous()
    W, r, xi2, m, c_inv, gain = _ring_state(W0, r0, xi20, c_inv, m0, gain, dev)
    G = torch.empty(-(-n // BLOCK_ROWS) * BLOCK_ROWS * BLOCK_ROWS, device=dev,
                    dtype=torch.float32)
    buf = torch.empty(bp * lookahead_max * d, device=dev, dtype=torch.float32)
    err = lib.streamsvm_scan_ring(
        X.data_ptr(), Y.data_ptr(), G.data_ptr(), W.data_ptr(), r.data_ptr(), xi2.data_ptr(),
        m.data_ptr(), c_inv.data_ptr(), gain.data_ptr(), L.data_ptr(), buf.data_ptr(), n,
        int(n_valid), d, bp, int(lookahead_max), plan["n_ctas"], _RING_LAYOUTS[plan["layout"]],
        _vec16(X), int(X.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "streamsvm_scan_ring (lookahead)")
    streamsvm_scan_lookahead_many_ring.launches += 1
    return W, r, xi2, m


streamsvm_scan_lookahead_many_ring.launches = 0  # kernel launches, read by chip_smoke.py


# ---------------------------------------------------------------------------
# B4: Algorithm 1 for one model
# ---------------------------------------------------------------------------


def _check_single_args(X, y, w0, block_n):
    n, d = X.shape
    if y.shape != (n,):
        raise ValueError(
            f"y must be (N,) signs matching X: got y.shape={tuple(y.shape)}, "
            f"X.shape={tuple(X.shape)}"
        )
    if w0.shape != (d,):
        raise ValueError(f"w0 must be (D,)=({d},): got {tuple(w0.shape)}")
    if n % block_n != 0:
        raise ValueError(
            f"N={n} must be a multiple of block_n={block_n} (pad the stream; "
            "ops.streamsvm_fit does this)"
        )


def _scalar(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(())


def streamsvm_scan_plain(X, y, w0, r0, xi20, c_inv, m0, gain, *, n_valid, block_n=256):
    """Plain PyTorch version of B4: the TPU kernel ``_kernel`` in the CUDA
    kernel's blocked form.

    Per block of ``block_n`` label-signed rows ``yx``: the Gram of ``yx`` and
    ``g = yx w``; then, row by row, the Gram-form distance, the update when
    ``d >= r`` (row valid, sign != 0), the rank-1 maintenance of ``g``, and
    the row's step kept as ``alpha`` and ``decay``; finally the deferred
    ``w <- decay * w + alpha yx``, the TPU kernel's per-row
    ``w <- (1-s) w + s yx_j`` in another order. ``gain`` is the slack gain
    (1/C for the exact variant, 1 for the paper's listing). Returns
    ``(w, r, xi2, m)``, the scalars 0-d (m int32).
    """
    _check_single_args(X, y, w0, block_n)
    torch.backends.cuda.matmul.allow_tf32 = False  # TF32 flips d >= r decisions
    dev = X.device
    n = min(int(n_valid), X.shape[0])
    w = w0.float().clone()
    r, xi2 = _scalar(r0, dev).clone(), _scalar(xi20, dev).clone()
    c_inv, gain = _scalar(c_inv, dev), _scalar(gain, dev)
    m = torch.as_tensor(m0, dtype=torch.int32, device=dev).reshape(()).clone()
    wsq = (w * w).sum()
    for i0 in range(0, n, block_n):
        yb = y[i0 : i0 + block_n].float()
        yx = X[i0 : i0 + block_n].float() * yb[:, None]
        gram = yx @ yx.T
        g = yx @ w
        rows = min(block_n, n - i0)
        alpha = torch.zeros(rows, dtype=torch.float32, device=dev)
        decay = torch.ones((), dtype=torch.float32, device=dev)
        signs = yb.tolist()
        for jr in range(rows):
            gj, gjj = g[jr], gram[jr, jr]
            d = torch.sqrt(torch.clamp(wsq - 2.0 * gj + gjj + xi2 + c_inv, min=1e-12))
            # A row that does not update leaves every quantity exactly as it
            # is (s = 0), so it is skipped.
            if signs[jr] == 0.0 or not bool(d >= r):
                continue
            s = 0.5 * (1.0 - r / d)
            one_s = 1.0 - s
            g = one_s * g + s * gram[jr]
            alpha = one_s * alpha
            alpha[jr] = s
            decay = decay * one_s
            wsq = one_s**2 * wsq + 2.0 * s * one_s * gj + s**2 * gjj
            r = r + 0.5 * (d - r)
            xi2 = xi2 * one_s**2 + s**2 * gain
            m = m + 1
        w = decay * w + alpha @ yx[:rows]
    return w, r, xi2, m


def streamsvm_scan(X, y, w0, r0, xi20, c_inv, m0, gain, *, n_valid, block_n=256):
    """B4 on the device of ``X``: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. Returns ``(w, r, xi2, m)``.

    X: (N, D) f32 stream; y: (N,) f32 signs (0: inert row); w0: (D,) f32;
    r0, xi20, c_inv, gain: scalars; m0: int.
    """
    if X.device.type == "cpu":
        return streamsvm_scan_plain(
            X, y, w0, r0, xi20, c_inv, m0, gain, n_valid=n_valid, block_n=block_n
        )
    if X.device.type != "cuda":
        raise ValueError(f"streamsvm_scan runs on cuda or cpu, not {X.device}")
    _check_single_args(X, y, w0, block_n)
    if X.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError(f"X and y must be float32: got {X.dtype}, {y.dtype}")
    dev = X.device
    n, d = X.shape
    X, y = X.contiguous(), y.contiguous()
    w = w0.to(dev, torch.float32).contiguous().clone()
    S = torch.stack([_scalar(v, dev) for v in (r0, xi20, c_inv, gain)])
    m = torch.as_tensor(m0, dtype=torch.int32, device=dev).reshape(1).clone()
    plan = single_plan(d)
    lib = _single_lib()
    bn = lib.streamsvm_single_block_rows()
    G = torch.empty(((n + bn - 1) // bn) * bn * bn, device=dev, dtype=torch.float32)
    err = lib.streamsvm_single(
        X.data_ptr(), y.data_ptr(), G.data_ptr(), w.data_ptr(), S.data_ptr(), m.data_ptr(),
        n, int(n_valid), d, int(plan["w_in_smem"]), plan["chunk"], _vec16(X),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "streamsvm_single")
    streamsvm_scan.launches += 1
    return w, S[0], S[1], m[0]


streamsvm_scan.launches = 0  # kernel launches, read by chip_smoke.py
