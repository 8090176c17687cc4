"""B2: score queries against a bank with a fused epilogue.

The port of the TPU kernel ``repro/kernels/predict.py::_kernel``
(``predict_bank_pallas``, with ``_first_argmax``). The kernel is CUDA C++
for Hopper, in ``csrc/predict.cu``; its header says how it is laid out and
what bounds it.

B6 serve, ``predict_bank_ring`` (``bank_resident="hbm"``), is the port of
the same ``_kernel`` with ``hbm=True``: each query tile walks the bank in
lane order through a 2-slot shared-memory ring, split along the bank over a
thread-block cluster. Both kernels run one register-tiled product body, so
the ring equals B2 bit for bit.

The topk epilogue serves any 1 <= k <= B: each query's running list sits in
shared memory up to ``TOPK_SMEM_MAX_K`` and in its own row of the outputs
past it, with the same insertion, so the ids do not depend on the layout.

``predict_bank_fused`` and ``predict_bank_ring`` dispatch on the device of
``Q``: a CPU tensor runs the plain version, a CUDA tensor launches the
kernel, or raises. Both take what ``ops.predict_bank`` prepares: Q padded to a whole number of
``q_block`` rows, the bank padded to whole ``b_tile`` tiles (for "ovr", to
whole groups of ``nc_pad`` class lanes) and a (B,) additive lane bias that
is 0 for live lanes and ``NEG_MASK`` for padding.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .streamsvm_scan import SMEM_PER_BLOCK

# Large-but-finite lane mask: padded bank lanes carry this additive bias so
# every real margin beats them (finite so bias + margin never becomes NaN).
NEG_MASK = -3.0e38

_EPILOGUES = {"scores": 0, "ovr": 1, "topk": 2}
_P, _I = ctypes.c_void_p, ctypes.c_int

#: Shared memory per CTA of B2's ``predict_kernel``, by term, as ptxas
#: places it: the 3-stage operand buffer (sized for the large 128-query tile,
#: 3 x (128 + 64) rows x 20 f32; the small 32-query tile uses less of it, and
#: the epilogue's 32-lane pieces reuse it once a chunk's steps have drained)
#: and the flag of the ovr merge (an int, padded to 16 B). Both tiles run in
#: this one arena, so the bytes do not depend on which tile a launch takes;
#: the topk lists add ``topk_state_bytes(k)``.
PREDICT_SMEM = {"stages": 46_080, "merge_flag": 16}
#: The same for B6 serve's ``predict_ring_kernel``: the same arena and no
#: flag (its merge waits on a cluster barrier).
PREDICT_RING_SMEM = {"stages": 46_080}


#: The largest k whose topk lists a launch keeps in shared memory (32 lists
#: of k (value, id) pairs beside B2's static bytes, within the card's
#: 232,448 B per block): ``predict_bank_max_k()`` of the kernel source. Past
#: it the lists are the (Q, k) outputs themselves, in device memory, and any
#: 1 <= k <= B runs with the same ids.
TOPK_SMEM_MAX_K = (SMEM_PER_BLOCK - sum(PREDICT_SMEM.values())) // (32 * 8)


def topk_state_bytes(k: int) -> int:
    """Dynamic shared memory of the topk epilogue: 32 (value, id) lists of k
    where they fit (k <= ``TOPK_SMEM_MAX_K``), else none."""
    return 32 * k * 8 if k <= TOPK_SMEM_MAX_K else 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("predict")
    lib.predict_bank.argtypes = [_P, _P, _P] + [_I] * 7 + [_P, _P, _P, _I, _P]
    lib.predict_bank.restype = ctypes.c_int
    lib.predict_bank_scratch_bytes.argtypes = [_I, _I, _I]
    lib.predict_bank_scratch_bytes.restype = ctypes.c_long
    lib.predict_bank_ring.argtypes = [_P, _P, _P] + [_I] * 6 + [_P, _P, _I, _P]
    lib.predict_bank_ring.restype = ctypes.c_int
    lib.predict_bank_ring_dyn_bytes.argtypes = [_I, _I]
    lib.predict_bank_ring_dyn_bytes.restype = ctypes.c_long
    return lib


def _check_args(Q, W, bias, epilogue, q_block, b_tile, nc_pad, k):
    qn, d = Q.shape
    bp, dw = W.shape
    if dw != d:
        raise ValueError(
            f"queries and bank must share the feature axis: got Q.shape="
            f"{tuple(Q.shape)}, W.shape={tuple(W.shape)}"
        )
    if bias.shape != (bp,):
        raise ValueError(
            f"bias must be (B,) matching the bank: got bias.shape="
            f"{tuple(bias.shape)}, W.shape={tuple(W.shape)}"
        )
    if qn % q_block != 0:
        raise ValueError(
            f"Q={qn} must be a multiple of q_block={q_block} (pad the "
            "queries; ops.predict_bank does this)"
        )
    if bp % b_tile != 0:
        raise ValueError(
            f"B={bp} must be a multiple of b_tile={b_tile} (pad the bank; "
            "ops.predict_bank does this)"
        )
    if epilogue == "ovr":
        if nc_pad is None or b_tile % nc_pad != 0:
            raise ValueError(
                f"epilogue='ovr' needs nc_pad dividing b_tile: got "
                f"nc_pad={nc_pad}, b_tile={b_tile}"
            )
    elif epilogue == "topk":
        if k is None or not 1 <= k <= bp:
            raise ValueError(f"epilogue='topk' needs 1 <= k <= B, got k={k}, B={bp}")
    elif epilogue != "scores":
        raise ValueError(
            f"unknown epilogue {epilogue!r}; expected 'scores', 'ovr' or 'topk'"
        )


def predict_bank_plain(Q, W, bias, *, epilogue="scores", q_block=256, b_tile=None,
                       nc_pad=None, k=None):
    """Plain PyTorch version of B2: one f32 product, then the epilogue.

    "scores" -> (Qn, Bp) f32 (no bias); "ovr" -> ((Qn, Bp/nc_pad) int32
    class lanes, f32 margins), first argmax per group; "topk" -> ((Qn, k)
    f32, (Qn, k) int32), descending, ties to the lowest lane.
    """
    b_tile = W.shape[0] if b_tile is None else b_tile
    _check_args(Q, W, bias, epilogue, q_block, b_tile, nc_pad, k)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 margins
    s = Q.float() @ W.float().T
    if epilogue == "scores":
        return s
    s = s + bias.float()[None, :]
    if epilogue == "ovr":
        grouped = s.reshape(s.shape[0], -1, nc_pad)
        arg = torch.argmax(grouped, dim=-1)  # the first maximum of each group
        return arg.to(torch.int32), grouped.amax(dim=-1)
    vals, ids = torch.sort(s, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), ids[:, :k].to(torch.int32)


def predict_bank_fused(Q, W, bias, *, epilogue="scores", q_block=256, b_tile=None,
                       nc_pad=None, k=None):
    """B2 on the device of ``Q``: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. Same arguments and results as
    ``predict_bank_plain``; Q is f32 or bf16, W and bias f32."""
    if Q.device.type == "cpu":
        return predict_bank_plain(
            Q, W, bias, epilogue=epilogue, q_block=q_block, b_tile=b_tile,
            nc_pad=nc_pad, k=k,
        )
    if Q.device.type != "cuda":
        raise ValueError(f"predict_bank_fused runs on cuda or cpu, not {Q.device}")
    b_tile = W.shape[0] if b_tile is None else b_tile
    _check_args(Q, W, bias, epilogue, q_block, b_tile, nc_pad, k)
    if Q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"Q must be float32 or bfloat16: got {Q.dtype}")
    lib = _lib()
    dev = Q.device
    qn, d = Q.shape
    bp = W.shape[0]
    Q = Q.contiguous()
    W = W.to(dev, torch.float32).contiguous()
    bias = bias.to(dev, torch.float32).contiguous()
    cols = {"scores": bp, "ovr": bp // nc_pad if nc_pad else 0, "topk": k}[epilogue]
    out_f = torch.empty((qn, cols), device=dev, dtype=torch.float32)
    out_i = torch.empty((qn, cols) if epilogue != "scores" else (1,), device=dev,
                        dtype=torch.int32)
    # The ovr merge's partials and arrival counters (cleared by the launch).
    nbytes = lib.predict_bank_scratch_bytes(qn, bp, _EPILOGUES[epilogue])
    scratch = torch.empty(nbytes, device=dev, dtype=torch.uint8) if nbytes else None
    err = lib.predict_bank(
        Q.data_ptr(), W.data_ptr(), bias.data_ptr(), qn, bp, d,
        _EPILOGUES[epilogue], int(nc_pad or 0), int(k or 0), int(b_tile),
        out_f.data_ptr(), out_i.data_ptr(), None if scratch is None else scratch.data_ptr(),
        int(Q.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "predict_bank")
    predict_bank_fused.launches += 1
    if epilogue == "scores":
        return out_f
    if epilogue == "ovr":
        return out_i, out_f
    return out_f, out_i


predict_bank_fused.launches = 0  # kernel launches, read by chip_smoke.py


# ---------------------------------------------------------------------------
# B6 serve: the bank walked through a ring (bank_resident="hbm")
# ---------------------------------------------------------------------------


def predict_bank_ring_plain(Q, W, bias, *, epilogue="scores", q_block=256, b_tile=None,
                            nc_pad=None, k=None):
    """Plain PyTorch version of B6 serve: B2's plain margins (the one f32
    product), met in the ring's order. Each query tile walks the bank tiles
    in lane order: "ovr" takes each tile's whole groups, "topk" merges each
    tile into a running list of k (a stable sort: ties stay with the lower
    lane). Same arguments and results as ``predict_bank_plain``, and equal
    to it bit for bit."""
    b_tile = W.shape[0] if b_tile is None else b_tile
    _check_args(Q, W, bias, epilogue, q_block, b_tile, nc_pad, k)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 margins
    s = Q.float() @ W.float().T
    if epilogue == "scores":
        return s
    s = s + bias.float()[None, :]
    parts_a, parts_b = [], []
    for q0 in range(0, s.shape[0], q_block):
        sq = s[q0 : q0 + q_block]
        if epilogue == "ovr":
            cls, best = [], []
            for b0 in range(0, W.shape[0], b_tile):
                grouped = sq[:, b0 : b0 + b_tile].reshape(sq.shape[0], -1, nc_pad)
                cls.append(torch.argmax(grouped, dim=-1).to(torch.int32))
                best.append(grouped.amax(dim=-1))
            parts_a.append(torch.cat(cls, 1))
            parts_b.append(torch.cat(best, 1))
            continue
        vals = sq[:, :0]
        ids = torch.zeros((sq.shape[0], 0), dtype=torch.int64, device=s.device)
        for b0 in range(0, W.shape[0], b_tile):
            lanes = torch.arange(b0, min(b0 + b_tile, W.shape[0]), device=s.device)
            vals = torch.cat([vals, sq[:, b0 : b0 + b_tile]], 1)
            ids = torch.cat([ids, lanes.expand(sq.shape[0], -1)], 1)
            vals, order = torch.sort(vals, dim=1, descending=True, stable=True)
            vals, ids = vals[:, :k], torch.gather(ids, 1, order)[:, :k]
        parts_a.append(vals.contiguous())
        parts_b.append(ids.to(torch.int32))
    return torch.cat(parts_a), torch.cat(parts_b)


def predict_bank_ring(Q, W, bias, *, epilogue="scores", q_block=256, b_tile=None,
                      nc_pad=None, k=None):
    """B6 serve on the device of ``Q``: the ring kernel for a CUDA tensor,
    the plain version for a CPU tensor. Same arguments and results as
    ``predict_bank_fused``; the kernel walks every lane, so ``b_tile`` only
    pads the bank. A launch the card refuses (the cluster too) raises."""
    if Q.device.type == "cpu":
        return predict_bank_ring_plain(
            Q, W, bias, epilogue=epilogue, q_block=q_block, b_tile=b_tile, nc_pad=nc_pad, k=k,
        )
    if Q.device.type != "cuda":
        raise ValueError(f"predict_bank_ring runs on cuda or cpu, not {Q.device}")
    b_tile = W.shape[0] if b_tile is None else b_tile
    _check_args(Q, W, bias, epilogue, q_block, b_tile, nc_pad, k)
    if Q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"Q must be float32 or bfloat16: got {Q.dtype}")
    lib = _lib()
    dev = Q.device
    qn, d = Q.shape
    bp = W.shape[0]
    Q = Q.contiguous()
    W = W.to(dev, torch.float32).contiguous()
    bias = bias.to(dev, torch.float32).contiguous()
    cols = {"scores": bp, "ovr": bp // nc_pad if nc_pad else 0, "topk": k}[epilogue]
    out_f = torch.empty((qn, cols), device=dev, dtype=torch.float32)
    out_i = torch.empty((qn, cols) if epilogue != "scores" else (1,), device=dev,
                        dtype=torch.int32)
    err = lib.predict_bank_ring(
        Q.data_ptr(), W.data_ptr(), bias.data_ptr(), qn, bp, d, _EPILOGUES[epilogue],
        int(nc_pad or 0), int(k or 0), out_f.data_ptr(), out_i.data_ptr(),
        int(Q.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "predict_bank_ring")
    predict_bank_ring.launches += 1
    if epilogue == "scores":
        return out_f
    if epilogue == "ovr":
        return out_i, out_f
    return out_f, out_i


predict_bank_ring.launches = 0  # kernel launches, read by chip_smoke.py
