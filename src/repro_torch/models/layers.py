"""Foundational layers of the LLM zoo: norms, RoPE, blocked attention, MLPs.

The port of the reference's ``models/layers.py`` as plain functions on
tensors. Params are nested dicts of tensors with the reference's names and
shapes. Compute dtype follows the input (bf16 in the published configs);
norm and softmax statistics are always f32. Attention is the reference's
online softmax over KV blocks, in plain torch: its masks are the finite
``-1e30`` (a fully masked block holds ``p = 1`` terms that the next
``exp(m - m_new)`` cancels), and its score and PV products take the
operands to f32 as the reference's ``preferred_element_type`` does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

_NEG_INF = -1e30


def init_dense(generator, shape, dtype, scale: float = 1.0, device=None):
    """N(0, scale^2 / fan_in) in f32, cast to ``dtype``; ``generator`` is a
    ``torch.Generator`` on ``device`` (None on the meta device)."""
    fan_in = shape[0] if len(shape) <= 2 else math.prod(shape[:-1])
    std = scale / max(fan_in, 1) ** 0.5
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32, device=device)
    return (w * std).to(dtype)


def rmsnorm(x, w, eps: float = 1e-5):
    """x * rsqrt(mean(x^2) + eps) * (1 + w), in f32, cast back to x's dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(x.dtype)


def layernorm(x, w, b, eps: float = 1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(x.dtype)


def rope_tables(positions, base, hd):
    """(cos, sin) of RoPE's angles for ``positions`` (..., S): (..., S, 1,
    hd // 2) in f32, the frequencies base^(-i / half) computed in f32."""
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freq = torch.pow(float(base), exps)  # the f32 power of the f32 base
    angles = positions[..., :, None].float() * freq  # (..., S, half)
    return torch.cos(angles)[..., :, None, :], torch.sin(angles)[..., :, None, :]


def rope(x, positions, base):
    """x: (..., S, H, hd); positions: (..., S). Rotates the two halves of the
    head (x1, x2) -> (x1 cos - x2 sin, x2 cos + x1 sin), in f32."""
    return _rotate(x, *rope_tables(positions, base, x.shape[-1]))


def _rotate(x, cos, sin):
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Blocked attention (online softmax over KV blocks)
# ---------------------------------------------------------------------------


def _block_mask(q_pos, k_pos, causal: bool, window):
    """(Sq, Sk) additive mask block from absolute positions."""
    m = torch.zeros((q_pos.shape[0], k_pos.shape[0]), dtype=torch.float32, device=q_pos.device)
    rel = q_pos[:, None] - k_pos[None, :]
    if causal:
        m = m.masked_fill(rel < 0, _NEG_INF)
    if window is not None:
        m = m.masked_fill(rel >= window, _NEG_INF)
    return m


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, KV, hd)
    v: torch.Tensor,  # (B, Sk, KV, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,  # absolute position of q[0] (decode: cache length)
    kv_valid_len: Optional[int] = None,  # mask kv positions >= this (cache decode)
    block_kv: int = 1024,
) -> torch.Tensor:
    """Grouped-query blocked attention; returns (B, Sq, H, hd).

    Loops over KV blocks with an online-softmax carry (m, l, acc): peak memory
    is O(Sq * block_kv) per head instead of O(Sq * Sk). The last block is
    zero-padded and its padding masked as positions >= Sk.
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / (hd**0.5)
    dev = q.device

    pad = (-Sk) % block_kv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    n_blocks = (Sk + pad) // block_kv

    qg = q.reshape(B, Sq, KV, G, hd).float()
    q_pos = q_offset + torch.arange(Sq, device=dev)
    kv_limit = Sk if kv_valid_len is None else kv_valid_len

    # the carries take qg's layout: on a mesh, its shards (a plain tensor
    # of the global shape would be replicated on every device)
    like = qg.permute(0, 2, 3, 1, 4)  # (B, KV, G, Sq, hd)
    dense = torch.contiguous_format
    m = torch.full_like(like[..., 0], _NEG_INF, memory_format=dense)
    l = torch.zeros_like(like[..., 0], memory_format=dense)
    acc = torch.zeros_like(like, memory_format=dense)
    for blk in range(n_blocks):
        lo = blk * block_kv
        kblk, vblk = k[:, lo : lo + block_kv], v[:, lo : lo + block_kv]
        k_pos = lo + torch.arange(block_kv, device=dev)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kblk.float()) * scale
        mask = _block_mask(q_pos, k_pos, causal, window)
        mask = mask.masked_fill(k_pos[None, :] >= kv_limit, _NEG_INF)
        s = s + mask
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(vblk.dtype).float(), vblk.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


def direct_attention(
    q, k, v, *, causal=True, window=None, q_offset=0, kv_valid_len=None
):
    """Unblocked attention for tiny Sq (decode): scores materialize as
    (B, KV, G, Sq, Sk)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    qg = q.reshape(B, Sq, KV, G, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    s = s / (hd**0.5)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    k_pos = torch.arange(Sk, device=dev)
    mask = _block_mask(q_pos, k_pos, causal, window)
    if kv_valid_len is not None:
        mask = mask.masked_fill(k_pos[None, :] >= kv_valid_len, _NEG_INF)
    s = s + mask
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(), v.float())
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Attention block (projections + rope + cache handling)
# ---------------------------------------------------------------------------


def attn_init(generator, d_model, n_heads, n_kv, hd, dtype, device=None):
    return {
        "wq": init_dense(generator, (d_model, n_heads, hd), dtype, device=device),
        "wk": init_dense(generator, (d_model, n_kv, hd), dtype, device=device),
        "wv": init_dense(generator, (d_model, n_kv, hd), dtype, device=device),
        "wo": init_dense(generator, (n_heads, hd, d_model), dtype, device=device),
    }


def attn_apply(
    p,
    x,
    *,
    rope_base=None,
    causal=True,
    window=None,
    kv_x=None,  # cross attention source
    cache=None,  # dict(k, v) fixed-size buffers (B, T, KV, hd), written in place
    cache_pos=None,  # int: current length (the write position)
    block_kv: int = 1024,
):
    """Returns (out, cache). x: (B, S, D).

    With a cache, the new k / v are written into ``cache`` in place at
    ``cache_pos`` (the reference returns an updated copy; its caller donates
    the old one), and attention runs over the whole buffer with positions
    ``>= cache_pos + S`` masked: direct attention for one token, the
    blocked form for a prompt.
    """
    S = x.shape[1]
    src = x if kv_x is None else kv_x
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", src, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", src, p["wv"])

    if cache is None:
        if rope_base is not None:
            pos = torch.arange(S, device=x.device)
            tables = rope_tables(pos, rope_base, q.shape[-1])  # shared by q and k
            q, k = _rotate(q, *tables), _rotate(k, *tables)
        out = flash_attention(
            q, k, v, causal=causal, window=window, block_kv=min(block_kv, k.shape[1]),
        )
    else:
        if rope_base is not None:
            pos = cache_pos + torch.arange(S, device=x.device)
            tables = rope_tables(pos, rope_base, q.shape[-1])  # shared by q and k
            q, k = _rotate(q, *tables), _rotate(k, *tables)
        ck, cv = cache["k"], cache["v"]
        ck[:, cache_pos : cache_pos + S] = k.to(ck.dtype)
        cv[:, cache_pos : cache_pos + S] = v.to(cv.dtype)
        if S == 1:
            out = direct_attention(
                q, ck, cv, causal=causal, window=window,
                q_offset=cache_pos, kv_valid_len=cache_pos + S,
            )
        else:
            out = flash_attention(
                q, ck, cv,
                causal=causal, window=window, q_offset=cache_pos,
                kv_valid_len=cache_pos + S,
                block_kv=min(block_kv, ck.shape[1]),
            )

    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return out, cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_init(generator, d_model, d_ff, kind, dtype, device=None):
    if kind in ("swiglu", "geglu"):
        return {
            "w1": init_dense(generator, (d_model, d_ff), dtype, device=device),
            "w3": init_dense(generator, (d_model, d_ff), dtype, device=device),
            "w2": init_dense(generator, (d_ff, d_model), dtype, device=device),
        }
    return {
        "w1": init_dense(generator, (d_model, d_ff), dtype, device=device),
        "w2": init_dense(generator, (d_ff, d_model), dtype, device=device),
    }


def mlp_apply(p, x, kind: str):
    """GELU is the tanh approximation, as ``jax.nn.gelu``'s default."""
    h = x @ p["w1"]
    if kind == "swiglu":
        h = F.silu(h) * (x @ p["w3"])
    elif kind == "geglu":
        h = F.gelu(h, approximate="tanh") * (x @ p["w3"])
    elif kind == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif kind == "sq_relu":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(kind)
    return h @ p["w2"]


def cross_entropy(logits, targets, ignore_index: int = -1):
    """Mean CE over valid targets. logits: (..., V) any float dtype.

    The target logit is picked by a one-hot contraction, as the reference's:
    with the vocab dim sharded over ``model``, a gather would all-gather the
    f32 logits, where the contraction reduces locally. Its value is the
    gather's to the bit (x + 0 is x in f32)."""
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    tgt = torch.clamp(targets, min=0).long()
    eq = torch.arange(logits.shape[-1], device=logits.device) == tgt[..., None]
    picked = torch.where(eq, logits32, 0.0).sum(-1)
    nll = lse - picked
    mask = (targets != ignore_index).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
