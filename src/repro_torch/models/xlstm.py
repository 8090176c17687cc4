"""xLSTM blocks: mLSTM (matrix memory, parallel/stabilized form) and sLSTM
(scalar memory, strictly sequential), wired per the xLSTM-125M layout
(1 sLSTM per `slstm_every` blocks, the rest mLSTM; no separate FFN).

The port of the reference's ``models/xlstm.py``. mLSTM without a state
over more than one token takes the quadratic stabilized parallel form;
with a state (prefill and decode) it runs the O(1) recurrence token by
token, as the reference's scan does. sLSTM always loops over time. Both
are constant-state in decode.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import init_dense, rmsnorm

_NEG = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_init(generator, d_model: int, n_heads: int, dtype, device=None):
    d_in = 2 * d_model

    def dense(shape, scale=1.0):
        return init_dense(generator, shape, dtype, scale=scale, device=device)

    return {
        "ln": torch.zeros((d_model,), dtype=dtype, device=device),
        "w_up": dense((d_model, 2 * d_in)),  # u, g
        "conv_w": dense((4, d_in), scale=2.0),
        "conv_b": torch.zeros((d_in,), dtype=dtype, device=device),
        "wq": dense((d_in, d_in)),
        "wk": dense((d_in, d_in)),
        "wv": dense((d_in, d_in)),
        "w_if": dense((d_in, 2 * n_heads)),
        "if_bias": torch.cat([
            torch.zeros((n_heads,), dtype=torch.float32, device=device),
            3.0 * torch.ones((n_heads,), dtype=torch.float32, device=device),
        ]),
        "w_down": dense((d_in, d_model)),
    }


def _conv4(x, w, b):
    """Causal depthwise conv over time: x (B, S, C), w (K, C), b (C,)."""
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i : i + S, :] * w[i] for i in range(K)) + b


def mlstm_parallel(q, k, v, i_pre, f_pre):
    """q,k,v: (B,S,H,hd); i_pre,f_pre: (B,S,H). Returns (B,S,H,hd)."""
    S, hd = q.shape[1], q.shape[3]
    logf = F.logsigmoid(f_pre.float())  # (B,S,H)
    Fc = torch.cumsum(logf, dim=1)
    # D[t,s] = F[t] - F[s] + i[s]  (s <= t)
    D = Fc[:, :, None, :] - Fc[:, None, :, :] + i_pre.float()[:, None, :, :]
    tri = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))[None, :, :, None]
    D = D.masked_fill(~tri, _NEG)  # (B,T,S,H)
    m = D.amax(dim=2)  # (B,T,H)
    Smat = torch.exp(D - m[:, :, None, :])
    qk = torch.einsum("bthd,bshd->btsh", q.float(), k.float())
    w = qk / (hd**0.5) * Smat
    denom = torch.maximum(w.sum(dim=2).abs(), torch.exp(-m))  # (B,T,H)
    y = torch.einsum("btsh,bshd->bthd", w, v.float())
    return (y / denom[..., None]).to(q.dtype)


def mlstm_step(state, q, k, v, i_pre, f_pre):
    """O(1) recurrence. state: (C (B,H,hd,hd), n (B,H,hd), m (B,H)).
    q,k,v: (B,H,hd); gates: (B,H). Returns (y (B,H,hd), new_state)."""
    C, n, m = state
    hd = q.shape[-1]
    logf = F.logsigmoid(f_pre.float())
    i = i_pre.float()
    m_new = torch.maximum(logf + m, i)
    fprime = torch.exp(logf + m - m_new)
    iprime = torch.exp(i - m_new)
    k32, v32, q32 = k.float(), v.float(), q.float()
    C = fprime[..., None, None] * C + iprime[..., None, None] * torch.einsum(
        "bhd,bhe->bhde", v32, k32
    )
    n = fprime[..., None] * n + iprime[..., None] * k32
    num = torch.einsum("bhde,bhe->bhd", C, q32) / (hd**0.5)
    den = torch.maximum(
        torch.einsum("bhd,bhd->bh", n, q32).abs() / (hd**0.5), torch.exp(-m_new)
    )
    y = num / den[..., None]
    return y.to(q.dtype), (C, n, m_new)


def mlstm_block(p, x, n_heads: int, *, state=None, conv_state=None):
    """x: (B,S,D). state=(C,n,m) for decode. Returns (out, (new_state, new_conv))."""
    B, S, D = x.shape
    d_in = 2 * D
    hd = d_in // n_heads
    hin = rmsnorm(x, p["ln"])
    ug = hin @ p["w_up"]
    u, g = ug.chunk(2, dim=-1)
    hist = u if conv_state is None else torch.cat([conv_state, u], dim=1)
    cv = _conv4(hist, p["conv_w"], p["conv_b"])
    if conv_state is not None:
        cv = cv[:, -S:, :]
    pad = max(0, 3 - hist.shape[1])
    new_conv = F.pad(hist, (0, 0, pad, 0))[:, -3:, :]
    c_act = F.silu(cv)
    q = (c_act @ p["wq"]).reshape(B, S, n_heads, hd)
    k = (c_act @ p["wk"]).reshape(B, S, n_heads, hd)
    v = (u @ p["wv"]).reshape(B, S, n_heads, hd)
    if_pre = c_act @ p["w_if"] + p["if_bias"]
    i_pre, f_pre = if_pre.chunk(2, dim=-1)  # (B,S,H)

    if state is None and S > 1:
        y = mlstm_parallel(q, k, v, i_pre, f_pre)
        new_state = None  # the parallel path threads no state
    else:
        st = state
        if st is None:
            st = (
                torch.zeros((B, n_heads, hd, hd), dtype=torch.float32, device=x.device),
                torch.zeros((B, n_heads, hd), dtype=torch.float32, device=x.device),
                torch.zeros((B, n_heads), dtype=torch.float32, device=x.device),
            )
        ys = []
        for t in range(S):
            yt, st = mlstm_step(st, q[:, t], k[:, t], v[:, t], i_pre[:, t], f_pre[:, t])
            ys.append(yt)
        new_state = st
        y = torch.stack(ys, dim=1)
    y = y.reshape(B, S, d_in) * F.silu(g)
    return x + y @ p["w_down"], (new_state, new_conv)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_init(generator, d_model: int, n_heads: int, dtype, device=None):
    dh = d_model // n_heads
    return {
        "ln": torch.zeros((d_model,), dtype=dtype, device=device),
        "W": init_dense(generator, (d_model, 4 * d_model), dtype, device=device),  # z i f o
        "R": init_dense(generator, (n_heads, dh, 4 * dh), dtype, device=device),  # block-diag
        "bias": torch.zeros((4 * d_model,), dtype=torch.float32, device=device),
        "w_out": init_dense(generator, (d_model, d_model), dtype, device=device),
    }


def slstm_block(p, x, n_heads: int, *, state=None):
    """x: (B,S,D). state=(c,n,m,h) each (B,D)-shaped (m,(B,H))."""
    B, S, D = x.shape
    dh = D // n_heads
    hin = rmsnorm(x, p["ln"])
    wx = (hin @ p["W"] + p["bias"].to(hin.dtype)).float()  # (B,S,4D)

    if state is None:
        dev = x.device
        c = torch.zeros((B, D), dtype=torch.float32, device=dev)
        n = torch.ones((B, D), dtype=torch.float32, device=dev)
        m = torch.zeros((B, n_heads), dtype=torch.float32, device=dev)
        h = torch.zeros((B, D), dtype=torch.float32, device=dev)
    else:
        c, n, m, h = state

    R = p["R"].float()
    hs = []
    for t in range(S):
        hh = h.reshape(B, n_heads, dh)
        rec = torch.einsum("bhd,hde->bhe", hh, R).reshape(B, 4 * D)
        z_, i_, f_, o_ = (wx[:, t] + rec).chunk(4, dim=-1)  # (B,D) each
        ih = i_.reshape(B, n_heads, dh)
        fh = f_.reshape(B, n_heads, dh)
        # stabilizer per head (max over units for a shared head-level m)
        logf = F.logsigmoid(fh)
        m_new = torch.maximum(logf.amax(-1) + m, ih.amax(-1))  # (B,H)
        iprime = torch.exp(ih - m_new[..., None]).reshape(B, D)
        fprime = torch.exp(logf + (m - m_new)[..., None]).reshape(B, D)
        z = torch.tanh(z_)
        o = torch.sigmoid(o_)
        c = fprime * c + iprime * z
        n = fprime * n + iprime
        h = o * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)  # (B,S,D)
    return x + y @ p["w_out"], (c, n, m, h)
