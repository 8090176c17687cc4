"""Hand-rolled AdamW on nested dicts of tensors.

The port of the reference's ``optim/adamw.py``. Moments are kept in
``moment_dtype`` (f32 by default; bf16 for the largest config); the update
runs in f32 in the reference's order of operations and casts back to each
param's dtype.

Peak memory: ``update`` writes the params and moments in place (the
reference's callers donate the state; here the caller's tensors are the new
state) and walks each leaf in slices of ``CHUNK`` elements, so its f32
temporaries are a few slices at a time, not a few copies of the largest
leaf. The operations are elementwise, so the slicing changes no bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .._tree import leaves, map_tree

#: Elements a slice of the leaf-by-leaf update (16 Mi: 64 MB a f32 temporary).
CHUNK = 1 << 24


class AdamWState(NamedTuple):
    m: dict
    v: dict
    step: torch.Tensor  # 0-d int32: updates taken


def init(params, moment_dtype=torch.float32) -> AdamWState:
    """Zero moments of ``moment_dtype`` beside every param, step 0."""
    first = leaves(params)[0]
    zeros = lambda x: torch.zeros(x.shape, dtype=moment_dtype, device=x.device)
    return AdamWState(
        m=map_tree(zeros, params),
        v=map_tree(zeros, params),
        step=torch.zeros((), dtype=torch.int32, device=first.device),
    )


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, over the leaves in flatten order, of each leaf's sum
    of squares in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves(tree)))


def update(
    grads,
    state: AdamWState,
    params,
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
):
    """Returns (new_params, new_state, metrics): ``params`` and the moments
    updated in place (and returned), the step a new tensor, and
    ``{"grad_norm"}`` before clipping. ``lr``: a float or a 0-d f32 tensor."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())

    def upd_block(g, m, v, p):
        g32 = g.float() * scale
        m32 = m.float() * b1 + (1.0 - b1) * g32
        v32 = v.float() * b2 + (1.0 - b2) * g32 * g32
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)

    def upd_leaf(g, m, v, p):
        if not (m.is_contiguous() and v.is_contiguous() and p.is_contiguous()):
            raise ValueError("adamw.update writes params and moments in place: they must be "
                             "contiguous")
        if type(p) is not torch.Tensor:  # a DTensor: elementwise on its shards, whole
            upd_block(g, m, v, p)
            return
        flat = [t.reshape(-1) for t in (g, m, v, p)]  # m, v, p: views
        for lo in range(0, p.numel(), CHUNK):
            upd_block(*(t[lo : lo + CHUNK] for t in flat))

    with torch.no_grad():
        map_tree(upd_leaf, grads, state.m, state.v, params)
    return params, AdamWState(m=state.m, v=state.v, step=step), {"grad_norm": gnorm}
