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
    port of ``_kernel`` / ``streamsvm_scan_pallas``.

The kernels are CUDA C++ for Hopper, B1 and B3 in ``csrc/streamsvm_scan.cu``,
B4 in ``csrc/streamsvm_single.cu``; their headers say how they are laid out
and what bounds them. Each wrapper dispatches on the device of ``X``: a CPU
tensor runs its ``*_plain`` twin, the TPU kernel's blocked algorithm in
plain PyTorch; a CUDA tensor launches the kernel, or raises. They take the
padded stream ``ops`` prepares: N a multiple of ``block_n``, B a multiple of
8, sign-0 rows and rows at or past ``n_valid`` inert.
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

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("streamsvm_scan")
    lib.streamsvm_scan_many.argtypes = [_P] * 9 + [_I] * 5 + [_P]
    lib.streamsvm_scan_many.restype = ctypes.c_int
    lib.streamsvm_scan_lookahead.argtypes = [_P] * 11 + [_I] * 6 + [_P]
    lib.streamsvm_scan_lookahead.restype = ctypes.c_int
    return lib


def _single_lib() -> ctypes.CDLL:
    lib = _build.load("streamsvm_single")
    lib.streamsvm_single.argtypes = [_P] * 6 + [_I] * 3 + [_P]
    lib.streamsvm_single.restype = ctypes.c_int
    return lib


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
        gram = x @ x.T
        g = ys * _grouped(w, x.T)
        alpha = torch.zeros_like(g)
        decay = torch.ones_like(r)
        # Rows at or past n_valid leave every quantity exactly as it is
        # (s = 0), so the loop stops at the last valid row.
        for jr in range(min(block_n, n - i0)):
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
    return w, r, xi2, m


def streamsvm_scan_many(
    X, Y, W0, r0, xi20, c_inv, m0, gain, *, n_valid, block_n=256, lookahead=None,
    lookahead_max=None,
):
    """B1 on the device of ``X``: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. Returns ``(W, r, xi2, m)``.

    X: (N, D) f32 or bf16 stream; Y: (B, N) signs of the same dtype; W0:
    (B, D) f32; r0, xi20, c_inv, gain: (B,) f32; m0: (B,) int32. With
    ``lookahead`` ((B,) int32 windows) and ``lookahead_max`` (their largest)
    it runs Algorithm 2 through B3 (``streamsvm_scan_lookahead_many``).
    """
    if lookahead is not None:
        return streamsvm_scan_lookahead_many(
            X, Y, W0, r0, xi20, c_inv, m0, gain, lookahead=lookahead,
            lookahead_max=lookahead_max, n_valid=n_valid, block_n=block_n,
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
    lib = _lib()
    bn = lib.streamsvm_scan_block_rows()
    G = torch.empty(((n + bn - 1) // bn) * bn * bn, device=dev, dtype=torch.float32)
    err = lib.streamsvm_scan_many(
        X.data_ptr(), Y.data_ptr(), G.data_ptr(), W.data_ptr(), r.data_ptr(),
        xi2.data_ptr(), m.data_ptr(), c_inv.data_ptr(), gain.data_ptr(),
        n, int(n_valid), d, bp, int(X.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "streamsvm_scan_many")
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
        gram = x @ x.T
        g = ys * _grouped(w, x.T)
        for jr in range(min(block_n, n - i0)):
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
    if x is not None and bool((cnt > 0).any()):  # the partial windows
        w, r, xi2, _ = _bank_flush_plain(w, r, xi2, g, cnt, buf, cnt > 0, x, ys, c_inv, gain)
    return w, r, xi2, m


def streamsvm_scan_lookahead_many(
    X, Y, W0, r0, xi20, c_inv, m0, gain, *, lookahead, lookahead_max, n_valid, block_n=256
):
    """B3 on the device of ``X``: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. Returns ``(W, r, xi2, m)``.

    Arguments as ``streamsvm_scan_many``, plus ``lookahead``: (B,) int32
    per-model windows (padded lanes 1), and ``lookahead_max``, their largest.
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
    bn = lib.streamsvm_scan_block_rows()
    G = torch.empty(((n + bn - 1) // bn) * bn * bn, device=dev, dtype=torch.float32)
    buf = torch.empty(bp * lookahead_max * d, device=dev, dtype=torch.float32)
    err = lib.streamsvm_scan_lookahead(
        X.data_ptr(), Y.data_ptr(), G.data_ptr(), W.data_ptr(), r.data_ptr(),
        xi2.data_ptr(), m.data_ptr(), c_inv.data_ptr(), gain.data_ptr(), L.data_ptr(),
        buf.data_ptr(), n, int(n_valid), d, bp, int(lookahead_max),
        int(X.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "streamsvm_scan_lookahead")
    streamsvm_scan_lookahead_many.launches += 1
    return W, r, xi2, m


streamsvm_scan_lookahead_many.launches = 0  # kernel launches, read by chip_smoke.py


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
    """Plain PyTorch version of B4: the TPU kernel ``_kernel``.

    Per block of ``block_n`` label-signed rows ``yx``: the Gram of ``yx`` and
    ``g = yx w``; then, row by row, the Gram-form distance, the update when
    ``d >= r`` (row valid, sign != 0), the rank-1 maintenance of ``g`` and
    ``w <- (1-s) w + s yx_j``. ``gain`` is the slack gain (1/C for the
    exact variant, 1 for the paper's listing). Returns ``(w, r, xi2, m)``,
    the scalars 0-d (m int32).
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
        signs = yb.tolist()
        for jr in range(min(block_n, n - i0)):
            gj, gjj = g[jr], gram[jr, jr]
            d = torch.sqrt(torch.clamp(wsq - 2.0 * gj + gjj + xi2 + c_inv, min=1e-12))
            # A row that does not update leaves every quantity exactly as it
            # is (s = 0), so it is skipped.
            if signs[jr] == 0.0 or not bool(d >= r):
                continue
            s = 0.5 * (1.0 - r / d)
            one_s = 1.0 - s
            g = one_s * g + s * gram[jr]
            w = one_s * w + s * yx[jr]
            wsq = one_s**2 * wsq + 2.0 * s * one_s * gj + s**2 * gjj
            r = r + 0.5 * (d - r)
            xi2 = xi2 * one_s**2 + s**2 * gain
            m = m + 1
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
    lib = _single_lib()
    bn = lib.streamsvm_single_block_rows()
    G = torch.empty(((n + bn - 1) // bn) * bn * bn, device=dev, dtype=torch.float32)
    err = lib.streamsvm_single(
        X.data_ptr(), y.data_ptr(), G.data_ptr(), w.data_ptr(), S.data_ptr(), m.data_ptr(),
        n, int(n_valid), d, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "streamsvm_single")
    streamsvm_scan.launches += 1
    return w, S[0], S[1], m[0]


streamsvm_scan.launches = 0  # kernel launches, read by chip_smoke.py
