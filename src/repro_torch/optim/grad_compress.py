"""Gradient compression for the cross-pod axis: top-k + error feedback, and
int8 quantization with a per-tensor scale.

The port of the reference's ``optim/grad_compress.py``. Its ``"pod"`` mesh
axis is a ``torch.distributed`` process group here: each rank compresses
its local gradient, the compressed (decompressed to dense) gradients are
all-reduced over the group, and the residual goes into an error-feedback
buffer so the compression is unbiased over time (Stich et al.; 1-bit Adam
lineage). ``top_k`` orders equal magnitudes by the lower index, as
``jax.lax.top_k`` does.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from .._ops import top_k
from .._tree import map_tree


class EFState(NamedTuple):
    residual: dict  # same structure/dtype as grads


def ef_init(grads_like):
    return EFState(residual=map_tree(torch.zeros_like, grads_like))


def topk_compress(x: torch.Tensor, frac: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the largest-|.| ``frac`` of entries (at least one). Returns
    (values, flat indices), largest magnitude first, ties by the lower index."""
    flat = x.reshape(-1)
    k = max(1, int(frac * flat.shape[0]))
    _, idx = top_k(flat.abs(), k)
    return flat[idx], idx


def topk_decompress(vals, idx, shape, dtype):
    flat = torch.zeros((math.prod(shape),), dtype=dtype, device=vals.device)
    flat[idx] = vals.to(dtype)
    return flat.reshape(shape)


def int8_quant(x: torch.Tensor):
    """(q int8, scale): q = clip(round(x / scale), -127, 127), rounding half
    to even, scale = max(max|x|, 1e-12) / 127."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequant(q, scale):
    return q.float() * scale


def _compress_one(g, r, frac):
    """One leaf: (the kept entries of g + r as a dense f32 tensor, g + r in f32)."""
    acc = g.float() + r.float()
    vals, idx = topk_compress(acc, frac)
    return topk_decompress(vals, idx, g.shape, torch.float32), acc


def compress_grads_topk(grads, ef: EFState, frac: float):
    """Error-feedback top-k: returns (sparse_grads_dense, new_ef).

    The returned tree is dense (decompressed) so it can flow into any
    optimizer; what would cross the wire is exactly the (vals, idx) pairs.
    """
    def one(g, r):
        dense, acc = _compress_one(g, r, frac)
        return dense.to(g.dtype), (acc - dense).to(r.dtype)

    dense, resid = _unzip(map_tree(one, grads, ef.residual))
    return dense, EFState(residual=resid)


def _unzip(tree):
    """A tree of pairs (the per-leaf results above) -> a pair of trees."""
    if isinstance(tree, dict):
        parts = {k: _unzip(v) for k, v in tree.items()}
        return {k: p[0] for k, p in parts.items()}, {k: p[1] for k, p in parts.items()}
    if isinstance(tree, list):
        parts = [_unzip(v) for v in tree]
        return [p[0] for p in parts], [p[1] for p in parts]
    return tree


def compressed_psum_pods(grads, mesh, frac: float, ef: EFState):
    """All-reduce gradients across the pods with top-k compression:
    g = sum over ranks of topk(g + r) / n_pods, and each rank's residual.

    ``mesh``: the process group that stands for the reference's ``"pod"``
    axis (None: the default group), or a ``DeviceMesh`` with a ``"pod"``
    dimension. Every rank calls it with grads of the same structure.
    """
    import torch.distributed as dist

    group = mesh.get_group("pod") if hasattr(mesh, "get_group") else mesh
    n_pods = dist.get_world_size(group)

    def one(g, r):
        dense, acc = _compress_one(g, r, frac)
        reduced = dense.clone()
        dist.all_reduce(reduced, op=dist.ReduceOp.SUM, group=group)
        return (reduced / n_pods).to(g.dtype), (acc - dense).to(r.dtype)

    dense, resid = _unzip(map_tree(one, grads, ef.residual))
    return dense, EFState(residual=resid)
