"""Mamba2 mixer (SSD, the state-space duality form), for zamba2.

The port of the reference's ``models/mamba2.py``. Training and prefill over
a multiple of the chunk take the chunked SSD algorithm: the intra-chunk
quadratic term plus the inter-chunk state recurrence (a loop over the
chunks, where the reference scans). Any other length, and every decode
step, takes the sequential recurrence token by token. Single B/C group,
per-head scalar A, D skip, causal depthwise conv on the xBC path.

The reference's four-operand einsums are written as explicit products in
a fixed order (``torch.einsum`` would contract them left to right), all in
f32 as the reference casts before them: ``C Bᵀ`` per chunk, times the
decay ``L``, against ``x dt``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sharding.hints import batch_full
from ._scan import scan
from .layers import init_dense, rmsnorm


def mamba_init(generator, d_model: int, ssm, dtype, device=None):
    d_in = ssm.expand * d_model
    n_heads = d_in // ssm.head_dim
    n = ssm.d_state
    d_proj = 2 * d_in + 2 * n + n_heads  # z, xBC, dt

    def full(shape, value, dt):
        return torch.full(shape, value, dtype=dt, device=device)

    return {
        "in_proj": init_dense(generator, (d_model, d_proj), dtype, device=device),
        "conv_w": init_dense(generator, (ssm.d_conv, d_in + 2 * n), dtype, scale=3.0,
                             device=device),
        "conv_b": full((d_in + 2 * n,), 0.0, dtype),
        "A_log": full((n_heads,), 0.0, torch.float32),  # A = -exp(A_log) = -1
        "D": full((n_heads,), 1.0, torch.float32),
        "dt_bias": full((n_heads,), 0.0, torch.float32),
        "norm": full((d_in,), 0.0, dtype),
        "out_proj": init_dense(generator, (d_in, d_model), dtype, device=device),
    }


def _causal_conv(x, w, b):
    """x: (B, S, C); w: (K, C) depthwise; left-padded causal."""
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i : i + S, :] * w[i] for i in range(K)) + b


def _segsum(a):
    """a: (..., L) -> (..., L, L) lower-triangular sums: out[t, s] =
    sum_{s<j<=t} a[j], -inf above the diagonal. The mask comes before any
    exp: above the diagonal the difference is positive and grows with the
    chunk, so an exp taken first overflows, and its inf is NaN in the
    backward pass."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~tri, float("-inf"))


def ssd_chunked(x, dt, A_log, B, C, chunk: int, init_state=None):
    """x: (b,s,h,p) pre-discretization; dt: (b,s,h) post-softplus;
    B, C: (b,s,n). Returns (y (b,s,h,p), final_state (b,h,p,n))."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd_chunked: sequence {s} is not a multiple of the chunk {chunk}")
    c = s // chunk
    A = -torch.exp(A_log)  # (h,)
    dA = dt * A  # (b,s,h)
    xdt = x * dt[..., None]  # discretized input

    dA_c = dA.reshape(b, c, chunk, h).permute(0, 1, 3, 2)  # (b,c,h,l)
    x_c = xdt.reshape(b, c, chunk, h, p).permute(0, 1, 3, 2, 4)  # (b,c,h,l,p)
    B_c = B.reshape(b, c, chunk, n)
    C_c = C.reshape(b, c, chunk, n)

    A_cs = torch.cumsum(dA_c, dim=-1)  # (b,c,h,l)

    # intra-chunk (diagonal blocks): ((C Bᵀ) * L) (x dt)
    L = torch.exp(_segsum(dA_c))  # (b,c,h,l,s)
    CB = C_c @ B_c.transpose(-1, -2)  # (b,c,l,s)
    Y_diag = (L * CB[:, :, None]) @ x_c  # (b,c,h,l,p)

    # per-chunk states: (x dt * decay)ᵀ B
    decay_states = torch.exp(A_cs[..., -1:] - A_cs)  # (b,c,h,l)
    states = (x_c * decay_states[..., None]).transpose(-1, -2) @ B_c[:, :, None]  # (b,c,h,p,n)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(A_cs[..., -1])  # (b,c,h)
    st = (batch_full(x, (b, h, p, n), 0.0, x.dtype)
          if init_state is None else init_state.to(x.dtype))
    prev = []
    for i in range(c):
        prev.append(st)
        st = st * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)  # (b,c,h,p,n)

    # off-diagonal: C against the entering state, times its decay
    state_decay_out = torch.exp(A_cs)  # (b,c,h,l)
    Y_off = (C_c[:, :, None] @ prev_states.transpose(-1, -2)) * state_decay_out[..., None]

    y = (Y_diag + Y_off).permute(0, 1, 3, 2, 4).reshape(b, s, h, p)
    return y, st


def _ssd_sequential(x, dt, A_log, B, C, state=None):
    """The recurrence token by token (decode and lengths not a multiple of
    the chunk). x: (b,s,h,p), dt: (b,s,h), B, C: (b,s,n), all f32."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    A = -torch.exp(A_log)
    st = (batch_full(x, (b, h, p, n), 0.0, torch.float32)
          if state is None else state.float())

    def step(st, t):
        dtt = dt[:, t]  # (b,h)
        dA = torch.exp(dtt * A)
        st = st * dA[..., None, None] + (x[:, t] * dtt[..., None])[..., None] * B[:, t, None, None, :]
        return st, st @ C[:, t, None, :, None]  # (b,h,p,1)

    st, ys = scan(step, st, s, name="mamba2", dim=-1, join=torch.cat)
    return ys.permute(0, 3, 1, 2), st


def mamba_apply(p, x, ssm, *, state=None, conv_state=None):
    """Full-sequence mixer. x: (B, S, D). Returns (out, (state, conv_state)).

    With ``state`` / ``conv_state`` it continues from them. The chunked SSD
    runs where S is a multiple of the chunk and S > 1, else the sequential
    recurrence. The new conv state is the last K - 1 raw xBC inputs
    (zero-padded when the sequence is short), in the model dtype; the SSM
    state is f32."""
    Bsz, S, D = x.shape
    d_in = ssm.expand * D
    h = d_in // ssm.head_dim
    n = ssm.d_state

    proj = x @ p["in_proj"]  # (B,S,2*d_in+2n+h)
    z, xBC, dt = torch.split(proj, [d_in, d_in + 2 * n, h], dim=-1)

    K1 = p["conv_w"].shape[0] - 1  # conv history length
    hist = xBC if conv_state is None else torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
    conv_out = _causal_conv(hist, p["conv_w"], p["conv_b"])
    if conv_state is not None:
        conv_out = conv_out[:, -S:, :]
    pad = max(0, K1 - hist.shape[1])
    new_conv_state = F.pad(hist, (0, 0, pad, 0))[:, -K1:, :]
    xBC_a = F.silu(conv_out)
    x_in, B_, C_ = torch.split(xBC_a, [d_in, n, n], dim=-1)
    x_h = x_in.reshape(Bsz, S, h, ssm.head_dim)
    dt_s = F.softplus(dt.float() + p["dt_bias"])  # (B,S,h)

    args = (x_h.float(), dt_s, p["A_log"], B_.float(), C_.float())
    if S % ssm.chunk == 0 and S > 1:
        y, new_state = ssd_chunked(*args, ssm.chunk, init_state=state)
    else:
        y, new_state = _ssd_sequential(*args, state=state)

    y = y + x_h.float() * p["D"][:, None]
    y = y.reshape(Bsz, S, d_in).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm(y, p["norm"])
    out = y @ p["out_proj"]
    return out, (new_state, new_conv_state)
