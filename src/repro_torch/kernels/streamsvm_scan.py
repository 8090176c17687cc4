"""B1: one pass of Algorithm 1 for a bank of B models over a shared stream.

The port of the Algorithm-1 branch of the TPU kernel
``repro/kernels/streamsvm_scan.py::_block_update`` (driven by
``_kernel_many_tiled`` / ``streamsvm_scan_many_pallas``). The kernel is
CUDA C++ for Hopper, in ``csrc/streamsvm_scan.cu``; its header says how it
is laid out and what bounds it.

``streamsvm_scan_many`` dispatches on the device of ``X``: a CPU tensor runs
``streamsvm_scan_many_plain``, the same blocked algorithm in plain PyTorch;
a CUDA tensor launches the kernel, or raises. Both take the padded stream
``ops.streamsvm_fit_many`` prepares: N a multiple of ``block_n``, B a
multiple of 8, sign-0 rows and rows at or past ``n_valid`` inert.
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


def streamsvm_scan_many(X, Y, W0, r0, xi20, c_inv, m0, gain, *, n_valid, block_n=256):
    """B1 on the device of ``X``: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. Returns ``(W, r, xi2, m)``.

    X: (N, D) f32 or bf16 stream; Y: (B, N) signs of the same dtype; W0:
    (B, D) f32; r0, xi20, c_inv, gain: (B,) f32; m0: (B,) int32.
    """
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
