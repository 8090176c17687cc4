"""B5: a Gram block K = epilogue(A B^T) with the linear or RBF epilogue.

The port of the TPU kernel ``repro/kernels/gram.py::_kernel``
(``gram_pallas``). The kernel is CUDA C++ for Hopper, in ``csrc/gram.cu``;
its header says how it is laid out and what bounds it.

``gram_fused`` dispatches on the device of ``A``: a CPU tensor runs
``gram_plain``, a CUDA tensor launches the kernel, or raises. Both take the
row norms from the caller, as ``gram_pallas`` does, and compute each element
as one f32 fused multiply-add chain, ``acc = fmaf(a_d, b_d, acc)`` over d
ascending from 0: the kernel with the card's ``fmaf``, the plain version
with ``fma32``, its exact float64 emulation. An element's value therefore
does not depend on the shape of the launch (a slice of B's rows gives the
bits of the whole), and the kernel computes the plain version's bits.
``row_norms`` (a second kernel in ``csrc/gram.cu``, with ``row_norms_plain``
beside it) gives the norms by the same chain over a row with itself, so
K(x, x)'s accumulator is the norm bit for bit, d^2 = 0 and the RBF diagonal
is exactly 1.

``tree_sum`` is the port's shape-independent reduction over the last axis:
a fixed halving tree, so the same row gives the same bits whatever else is
in the tensor, on either device.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_EPILOGUES = {"linear": 0, "rbf": 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: Shared memory per CTA of ``gram_kernel``, as declared: the product
#: body's 3-stage operand arena, sized for the large tile, 3 x (128 + 64)
#: rows x 20 f32, whichever tile a launch takes (the kernel bank's byte
#: model reads it).
GRAM_SMEM = 46_080


def _lib() -> ctypes.CDLL:
    lib = _build.load("gram")
    lib.gram.argtypes = [_P] * 4 + [_I] * 4 + [_F, _P, _I, _P]
    lib.gram.restype = ctypes.c_int
    lib.gram_row_norms.argtypes = [_P, _I, _I, _P, _I, _P]
    lib.gram_row_norms.restype = ctypes.c_int
    return lib


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by a halving tree: zero-pad the axis to a power
    of two P, then ``x[..., :h] + x[..., h:]`` for h = P/2, ..., 1. Each
    output depends only on its own row, in a fixed order (the R1 kernel's
    warp reductions add in the same tree)."""
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``fmaf(a, b, c)``, a * b + c rounded once, on any device: exact in
    float64 by round-to-odd. The product of two f32 values is exact in
    float64; the sum s = p + c is rounded there, with its error e from
    TwoSum; where e is not 0 and s's last bit is even, s steps one ulp toward
    e (the sum rounded to odd), and rounding that to f32 is then the exact
    sum rounded once (53 >= 24 + 2 bits). Non-finite sums are kept as they
    are. Broadcasts like ``torch.addcmul``; returns f32."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    e = (p - (s - bb)) + (cd - bb)
    step = (e != 0) & ((s.view(torch.int64) & 1) == 0) & torch.isfinite(s)
    toward = torch.where(e > 0, torch.inf, -torch.inf).to(torch.float64)
    return torch.where(step, torch.nextafter(s, toward), s).float()


def row_norms_plain(A: torch.Tensor) -> torch.Tensor:
    """(M,) f32 squared row norms of A (upcast first): the Gram's chain,
    fmaf(a_d, a_d, acc) over d ascending."""
    A = A.float()
    acc = torch.zeros((A.shape[0],), dtype=torch.float32, device=A.device)
    for k in range(A.shape[1]):
        acc = fma32(A[:, k], A[:, k], acc)
    return acc


def row_norms(A: torch.Tensor) -> torch.Tensor:
    """Squared row norms for B5's RBF epilogue on the device of ``A``: the
    kernel for a CUDA tensor, ``row_norms_plain`` for a CPU tensor. A: (M,
    D) f32 or bf16. Returns (M,) f32."""
    if A.device.type == "cpu":
        return row_norms_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"row_norms runs on cuda or cpu, not {A.device}")
    if A.ndim != 2:
        raise ValueError(f"row_norms takes a 2-D (M, D) tensor: got {tuple(A.shape)}")
    if A.dtype != torch.bfloat16:
        A = A.float()
    A = A.contiguous()
    out = torch.empty((A.shape[0],), device=A.device, dtype=torch.float32)
    err = _lib().gram_row_norms(
        A.data_ptr(), A.shape[0], A.shape[1], out.data_ptr(),
        int(A.dtype == torch.bfloat16), torch.cuda.current_stream(A.device).cuda_stream,
    )
    _build.check(err, "gram_row_norms")
    row_norms.launches += 1
    return out


row_norms.launches = 0  # kernel launches, read by chip_smoke.py


def _check_args(A, B, an, bn, epilogue):
    if A.ndim != 2 or B.ndim != 2 or A.shape[1] != B.shape[1]:
        raise ValueError(
            f"A and B must be 2-D and share the feature axis: got "
            f"A.shape={tuple(A.shape)}, B.shape={tuple(B.shape)}"
        )
    if an.shape != (A.shape[0],) or bn.shape != (B.shape[0],):
        raise ValueError(
            f"row norms must be (M,) and (N,): got an.shape={tuple(an.shape)}, "
            f"bn.shape={tuple(bn.shape)} for A.shape={tuple(A.shape)}, "
            f"B.shape={tuple(B.shape)}"
        )
    if epilogue not in _EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; expected 'linear' or 'rbf'")


def _epilogue(acc, an, bn, gamma, epilogue):
    if epilogue == "linear":
        return acc
    d2 = (an[:, None] + bn[None, :]) - 2.0 * acc
    return torch.exp(-float(gamma) * torch.clamp(d2, min=0.0))


#: Elements per block of rows in ``gram_plain`` (bounds its float64
#: temporaries; an element's value does not depend on the block).
_PLAIN_BLOCK = 1 << 22


def gram_plain(A, B, an, bn, gamma=1.0, *, epilogue="linear"):
    """Plain PyTorch version of B5: ``A @ B.T`` as one ``fma32`` chain per
    element over d ascending from 0 (the kernel's arithmetic, so any shape
    of launch gives the same bits per element), then the epilogue. Rows of A
    are taken in blocks of at most ``_PLAIN_BLOCK`` elements. (M, N) f32."""
    _check_args(A, B, an, bn, epilogue)
    A, B = A.float(), B.float()
    m, n = A.shape[0], B.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=A.device)
    rows = max(1, _PLAIN_BLOCK // max(n, 1))
    for r0 in range(0, m, rows):
        a = A[r0 : r0 + rows]
        acc = torch.zeros((a.shape[0], n), dtype=torch.float32, device=A.device)
        for k in range(A.shape[1]):
            acc = fma32(a[:, k, None], B[None, :, k], acc)
        out[r0 : r0 + rows] = _epilogue(acc, an[r0 : r0 + rows].float(), bn.float(), gamma,
                                        epilogue)
    return out


def gram_fused(A, B, an, bn, gamma=1.0, *, epilogue="linear"):
    """B5 on the device of ``A``: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. A: (M, D) f32 or bf16; B: (N, D) f32;
    an, bn: (M,), (N,) f32 squared row norms (read for "rbf" only); gamma a
    Python float. Returns K (M, N) f32."""
    if A.device.type == "cpu":
        return gram_plain(A, B, an, bn, gamma, epilogue=epilogue)
    if A.device.type != "cuda":
        raise ValueError(f"gram_fused runs on cuda or cpu, not {A.device}")
    _check_args(A, B, an, bn, epilogue)
    if A.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"A must be float32 or bfloat16: got {A.dtype}")
    dev = A.device
    m, d = A.shape
    n = B.shape[0]
    A = A.contiguous()
    B = B.to(dev, torch.float32).contiguous()
    an = an.to(dev, torch.float32).contiguous()
    bn = bn.to(dev, torch.float32).contiguous()
    out = torch.empty((m, n), device=dev, dtype=torch.float32)
    err = _lib().gram(
        A.data_ptr(), B.data_ptr(), an.data_ptr(), bn.data_ptr(), m, n, d,
        _EPILOGUES[epilogue], float(gamma), out.data_ptr(),
        int(A.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "gram")
    gram_fused.launches += 1
    return out


gram_fused.launches = 0  # kernel launches, read by chip_smoke.py
