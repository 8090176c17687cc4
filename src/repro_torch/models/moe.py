"""Top-k MoE FFN with sort-based capacity dispatch (dropless up to capacity).

The port of the reference's ``models/moe.py``, to the letter: tokens are
routed top-k by an f32 router and softmax (gates renormalised), sorted by
expert id (stable), placed into an (E, C, D) buffer at their within-expert
slot (an exclusive cumsum of the expert counts), run through the three
expert products as batched products over the expert axis, and combined
back with a scatter-add weighted by the gates.

Capacity C = max(1, int(capacity_factor * T * k / E)) for the T tokens of
the call; assignments past it drop (their residual path passes through
unchanged). C depends on T: a decode step of 8 tokens at 128 experts, top-8
has C = 1, where the teacher-forced forward over the same tokens has more.
Returns the Switch-style load-balancing aux loss beside the output.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .._ops import top_k
from .layers import init_dense


def moe_init(generator, d_model: int, moe_cfg, dtype, device=None):
    """Router (D, E) in f32; experts w1, w3 (E, D, F) and w2 (E, F, D) in
    ``dtype``; each N(0, 1 / fan_in) with fan_in the product of all axes
    but the last (E * D for an expert leaf, as the reference's)."""
    E, Fd = moe_cfg.n_experts, moe_cfg.d_ff
    return {
        "router": init_dense(generator, (d_model, E), torch.float32, device=device),
        "w1": init_dense(generator, (E, d_model, Fd), dtype, device=device),
        "w3": init_dense(generator, (E, d_model, Fd), dtype, device=device),
        "w2": init_dense(generator, (E, Fd, d_model), dtype, device=device),
    }


def capacity(moe_cfg, n_tokens: int) -> int:
    return max(1, int(moe_cfg.capacity_factor * n_tokens * moe_cfg.top_k / moe_cfg.n_experts))


def moe_apply(p, x, moe_cfg, stats=None):
    """x: (B, S, D) -> (out (B, S, D), aux_loss 0-d f32).

    ``stats``: a list to which the call appends ``{"capacity": C,
    "dropped": the count of assignments past capacity (a 0-d tensor),
    "experts": each token's K experts (T, K), "kept": (T, K) bool, False
    where that assignment was dropped, "aux": the layer's aux}`` (a
    checkpointed layer appends again when the backward pass recomputes it)."""
    B, S, D = x.shape
    T = B * S
    E, K = moe_cfg.n_experts, moe_cfg.top_k
    C = capacity(moe_cfg, T)
    xt = x.reshape(T, D)
    dev = x.device

    logits = xt.float() @ p["router"]  # (T, E) f32
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = top_k(probs, K)  # (T, K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    flat_e = eidx.reshape(-1)  # (T*K,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    flat_g = gate.reshape(-1)

    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    counts = torch.zeros(E, dtype=torch.long, device=dev).index_add(
        0, flat_e, torch.ones_like(flat_e))  # bincount's counts, with an output size known upfront
    seg_start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * K, device=dev) - seg_start[se]  # within-expert slot

    # dispatch: assignments past capacity fall off (the reference's
    # mode="drop"); they are written to a spare row past the E * C slots,
    # which no product reads, so nothing waits on the count of kept ones
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=dev).index_put((slot,), xt[st])
    buf = buf[: E * C].view(E, C, D)

    h1 = torch.bmm(buf, p["w1"])
    h3 = torch.bmm(buf, p["w3"])
    h = F.silu(h1) * h3
    out_e = torch.bmm(h, p["w2"])  # (E, C, D)

    zero = torch.zeros((1, D), dtype=out_e.dtype, device=dev)
    vals = torch.cat([out_e.reshape(E * C, D), zero])[slot]  # 0 where dropped
    out = torch.zeros((T, D), dtype=x.dtype, device=dev).index_add(
        0, st, (vals * sg[:, None]).to(x.dtype))

    # Switch-style load-balance loss: E * sum_e f_e * p_e
    frac = counts.float() / (T * K)
    mean_prob = probs.mean(0)
    aux = E * torch.sum(frac * mean_prob)
    if stats is not None:
        kept = torch.zeros_like(keep).index_put((order,), keep).view(T, K)
        stats.append({"capacity": C, "dropped": (~keep).sum(), "experts": eidx, "kept": kept,
                      "aux": aux})
    return out.reshape(B, S, D), aux
