"""Model classes beyond the decoder-only transformer, with DecoderLM's API
(init / loss / prefill / decode_step / init_cache / decode_state).

The port of the reference's ``models/families.py``: ``Zamba2Model`` (the
hybrid family: a Mamba2 backbone with one shared attention block),
``XLSTMModel`` (the ssm family) and ``EncDecModel`` (Whisper; its conv
audio frontend is a stub, ``frames`` arrive as precomputed (B,
encoder_seq, d_model) embeddings). ``loss`` is differentiable; ``remat``
other than ``"none"`` recomputes each checkpointed layer whole in the
backward pass, as the reference's ``jax.checkpoint`` without a policy.
``prefill`` and ``decode_step`` run under ``torch.inference_mode()`` and
write attention caches in place (clone a cache that is still needed).
"""
from __future__ import annotations

import torch

from repro_torch._device import pick_device
from repro_torch.configs.base import ArchConfig
from repro_torch.sharding.hints import cache_hint, shard_hint
from .layers import attn_apply, attn_init, cross_entropy, init_dense, mlp_apply, mlp_init, rmsnorm
from .mamba2 import mamba_apply, mamba_init
from .transformer import _dtype, _generator, remat_layer
from .xlstm import mlstm_block, mlstm_init, slstm_block, slstm_init


def _embed(params, tokens):
    emb = params["embed"]
    return emb[torch.as_tensor(tokens, device=emb.device).long()]


def _checkpointed(fn, remat):
    """``fn`` recomputed whole in the backward pass unless ``remat`` is
    "none" or no graph is being built."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    return remat_layer(fn, "full")


# ---------------------------------------------------------------------------
# Zamba2 — mamba2 backbone + one shared attention block every k layers
# ---------------------------------------------------------------------------


class Zamba2Model:
    """Shared transformer block (attn + mlp, a single set of weights)
    applied before every ``shared_attn_every``-th mamba2 layer. Each
    application has its own slice of one KV buffer (n_shared, B, T, KV,
    hd). As the reference: the shared block consumes the hidden state
    directly (no concat-with-embedding projector)."""

    def __init__(self, cfg: ArchConfig, remat: str = "none"):
        self.cfg = cfg
        self.remat = remat
        self.dtype = _dtype(cfg.param_dtype)
        self.n_shared = len(self._shared_sites())

    def _shared_sites(self):
        every = self.cfg.shared_attn_every
        return [i for i in range(self.cfg.n_layers) if every and i % every == 0]

    def init(self, generator=None, device=None):
        """Random params from ``generator`` (default: seed 0 on the device)."""
        cfg = self.cfg
        dev = pick_device(device)
        gen = _generator(generator, dev)
        zeros = lambda: torch.zeros((cfg.d_model,), dtype=self.dtype, device=dev)
        embed = init_dense(gen, (cfg.vocab, cfg.d_model), self.dtype, device=dev)
        mamba = [{"ln": zeros(), "mix": mamba_init(gen, cfg.d_model, cfg.ssm, self.dtype,
                                                   device=dev)}
                 for _ in range(cfg.n_layers)]
        shared = {
            "ln1": zeros(),
            "attn": attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                              self.dtype, device=dev),
            "ln2": zeros(),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp, self.dtype, device=dev),
        }
        return {
            "embed": embed,
            "mamba": mamba,
            "shared": shared,
            "final_norm": zeros(),
            "unembed": init_dense(gen, (cfg.d_model, cfg.vocab), self.dtype, device=dev),
        }

    def _shared_block(self, p, h, cache=None, cache_pos=None):
        cfg = self.cfg
        a, _ = attn_apply(
            p["attn"], rmsnorm(h, p["ln1"], cfg.norm_eps),
            rope_base=cfg.rope_base, causal=True, cache=cache, cache_pos=cache_pos,
        )
        h = h + a
        return h + mlp_apply(p["mlp"], rmsnorm(h, p["ln2"], cfg.norm_eps), cfg.mlp)

    def _mamba_layer(self, lp, h, st=None, cv=None):
        cfg = self.cfg
        out, states = mamba_apply(lp["mix"], rmsnorm(h, lp["ln"], cfg.norm_eps), cfg.ssm,
                                  state=st, conv_state=cv)
        return h + out, states

    def _forward(self, params, h, caches=None, cache_pos=None):
        """caches: {"kv": {"k", "v"} (n_shared, B, T, KV, hd), written in
        place; "ssm", "conv": a list a layer}. Returns (h, new caches or
        None)."""
        cfg = self.cfg
        sites = set(self._shared_sites())
        layer = self._mamba_layer if caches is not None else _checkpointed(
            self._mamba_layer, self.remat)
        new_ssm, new_conv = [], []
        si = 0
        for i in range(cfg.n_layers):
            if i in sites:
                c = None if caches is None else {k: v[si] for k, v in caches["kv"].items()}
                h = self._shared_block(params["shared"], h, cache=c, cache_pos=cache_pos)
                si += 1
            st = None if caches is None else caches["ssm"][i]
            cv = None if caches is None else caches["conv"][i]
            h, (nst, ncv) = layer(params["mamba"][i], h, st, cv)
            new_ssm.append(nst)
            new_conv.append(ncv)
        if caches is None:
            return h, None
        return h, {"kv": caches["kv"], "ssm": new_ssm, "conv": new_conv}

    def _logits(self, params, h):
        logits = rmsnorm(h, params["final_norm"], self.cfg.norm_eps) @ params["unembed"]
        return shard_hint(logits, ("dp", None, "tp"))  # vocab-sharded logits

    def loss(self, params, batch):
        """(ce, {"ce", "aux": 0.0}), differentiable in the params."""
        h = _embed(params, batch["tokens"])
        h, _ = self._forward(params, h)
        targets = torch.as_tensor(batch["targets"], device=h.device).long()
        ce = cross_entropy(self._logits(params, h), targets)
        return ce, {"ce": ce, "aux": 0.0}

    def init_cache(self, batch_size: int, max_len: int, device=None):
        """{"kv": {"k", "v"} (n_shared, B, max_len, KV, hd) in the model
        dtype; "ssm": (B, heads, head_dim, d_state) f32 a layer; "conv":
        (B, d_conv - 1, d_inner + 2 d_state) in the model dtype a layer}."""
        cfg = self.cfg
        dev = pick_device(device)
        d_in = cfg.ssm.expand * cfg.d_model
        nh = d_in // cfg.ssm.head_dim
        kv_shape = (self.n_shared, batch_size, max_len, cfg.n_kv_heads, cfg.hd)
        return cache_hint({
            "kv": {"k": torch.zeros(kv_shape, dtype=self.dtype, device=dev),
                   "v": torch.zeros(kv_shape, dtype=self.dtype, device=dev)},
            "ssm": [torch.zeros((batch_size, nh, cfg.ssm.head_dim, cfg.ssm.d_state),
                                dtype=torch.float32, device=dev)
                    for _ in range(cfg.n_layers)],
            "conv": [torch.zeros((batch_size, cfg.ssm.d_conv - 1, d_in + 2 * cfg.ssm.d_state),
                                 dtype=self.dtype, device=dev)
                     for _ in range(cfg.n_layers)],
        })

    def prefill(self, params, batch):
        """``batch["max_len"]`` (default: the prompt's length) sizes the KV
        buffer. Returns (last logits (B, V), {"c": caches, "pos": S})."""
        with torch.inference_mode():
            tokens = batch["tokens"]
            B, S = tokens.shape
            h = _embed(params, tokens)
            caches = self.init_cache(B, batch.get("max_len", S), device=h.device)
            h, caches = self._forward(params, h, caches=caches, cache_pos=0)
            logits = self._logits(params, h[:, -1:])
        return logits[:, 0], {"c": caches, "pos": S}

    def decode_step(self, params, cache, tokens):
        with torch.inference_mode():
            h = _embed(params, tokens)
            h, caches = self._forward(params, h, caches=cache["c"], cache_pos=cache["pos"])
            logits = self._logits(params, h)
        return logits[:, 0], {"c": caches, "pos": cache["pos"] + tokens.shape[1]}

    def decode_state(self, batch_size: int, max_len: int, device=None):
        return {"c": self.init_cache(batch_size, max_len, device=device), "pos": max_len - 1}


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------


class XLSTMModel:
    def __init__(self, cfg: ArchConfig, remat: str = "none"):
        self.cfg = cfg
        self.remat = remat
        self.dtype = _dtype(cfg.param_dtype)

    def _is_slstm(self, i: int) -> bool:
        e = self.cfg.slstm_every
        return bool(e) and (i % e == e - 1)

    def init(self, generator=None, device=None):
        """Random params from ``generator`` (default: seed 0 on the device)."""
        cfg = self.cfg
        dev = pick_device(device)
        gen = _generator(generator, dev)
        blocks = []
        for i in range(cfg.n_layers):
            blk_init = slstm_init if self._is_slstm(i) else mlstm_init
            blocks.append(blk_init(gen, cfg.d_model, cfg.n_heads, self.dtype, device=dev))
        return {
            "embed": init_dense(gen, (cfg.vocab, cfg.d_model), self.dtype, device=dev),
            "blocks": blocks,
            "final_norm": torch.zeros((cfg.d_model,), dtype=self.dtype, device=dev),
            "unembed": init_dense(gen, (cfg.d_model, cfg.vocab), self.dtype, device=dev),
        }

    def _forward(self, params, h, states=None):
        cfg = self.cfg
        new_states = []
        remat = self.remat if states is None else "none"
        slstm, mlstm = (_checkpointed(b, remat) for b in (slstm_block, mlstm_block))
        for i in range(cfg.n_layers):
            st = None if states is None else states[i]
            if self._is_slstm(i):
                h, ns = slstm(params["blocks"][i], h, cfg.n_heads, state=st)
            else:
                mst = None if st is None else st[0]
                cst = None if st is None else st[1]
                h, ns = mlstm(
                    params["blocks"][i], h, cfg.n_heads, state=mst, conv_state=cst
                )
            new_states.append(ns)
        return h, new_states

    def _logits(self, params, h):
        logits = rmsnorm(h, params["final_norm"], self.cfg.norm_eps) @ params["unembed"]
        return shard_hint(logits, ("dp", None, "tp"))

    def loss(self, params, batch):
        """(ce, {"ce", "aux": 0.0}), differentiable in the params."""
        h = _embed(params, batch["tokens"])
        h, _ = self._forward(params, h)
        targets = torch.as_tensor(batch["targets"], device=h.device).long()
        ce = cross_entropy(self._logits(params, h), targets)
        return ce, {"ce": ce, "aux": 0.0}

    def init_cache(self, batch_size: int, max_len: int, device=None):
        """Per block: sLSTM (c, n, m, h); mLSTM ((C, n, m), conv_state (B, 3,
        d_in) in the model dtype). ``max_len`` is unused: the state is
        constant-size."""
        cfg = self.cfg
        B = batch_size
        dev = pick_device(device)
        d_in = 2 * cfg.d_model
        hd = d_in // cfg.n_heads

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        states = []
        for i in range(cfg.n_layers):
            if self._is_slstm(i):
                states.append((
                    zeros(B, cfg.d_model),
                    torch.ones((B, cfg.d_model), dtype=torch.float32, device=dev),
                    zeros(B, cfg.n_heads),
                    zeros(B, cfg.d_model),
                ))
            else:
                states.append((
                    (zeros(B, cfg.n_heads, hd, hd), zeros(B, cfg.n_heads, hd),
                     zeros(B, cfg.n_heads)),
                    zeros(B, 3, d_in, dtype=self.dtype),
                ))
        return cache_hint(states)

    def prefill(self, params, batch):
        with torch.inference_mode():
            tokens = batch["tokens"]
            B, S = tokens.shape
            h = _embed(params, tokens)
            states = self.init_cache(B, 0, device=h.device)
            h, states = self._forward(params, h, states=states)
            logits = self._logits(params, h[:, -1:])
        return logits[:, 0], {"c": states, "pos": S}

    def decode_step(self, params, cache, tokens):
        with torch.inference_mode():
            h = _embed(params, tokens)
            h, states = self._forward(params, h, states=cache["c"])
            logits = self._logits(params, h)
        return logits[:, 0], {"c": states, "pos": cache["pos"] + tokens.shape[1]}

    def decode_state(self, batch_size: int, max_len: int, device=None):
        # constant-size recurrent state: max_len only sets the position
        return {"c": self.init_cache(batch_size, 0, device=device), "pos": max_len - 1}


# ---------------------------------------------------------------------------
# Whisper (enc-dec); the conv audio frontend is a stub: ``frames`` arrive as
# precomputed (B, encoder_seq, d_model) embeddings.
# ---------------------------------------------------------------------------

_POS_ROWS = 65536  # the decoder's sinusoid table, as the reference's


def _sinusoid(S, D, device=None):
    """(S, D) f32: sin and cos of pos / 10000^(2i / D), the halves side by side."""
    pos = torch.arange(S, device=device, dtype=torch.float32)[:, None]
    i = torch.arange(D // 2, device=device, dtype=torch.float32)[None, :]
    ang = pos / torch.pow(10000.0, 2 * i / D)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncDecModel:
    """The encoder runs non-causal attention over ``frames`` plus a
    sinusoid; the decoder (sinusoid positions from ``cache_pos``, no RoPE)
    runs causal self-attention and cross-attention to the encoder's output,
    whose K / V are recomputed from ``enc_out`` at every step as the
    reference does. Encoder layers are checkpointed whenever ``remat`` is
    not "none", decoder layers only without a cache. The decode cache is
    ``{"kv": {"k", "v"} (L, B, T, KV, hd), "enc": enc_out, "pos"}``."""

    def __init__(self, cfg: ArchConfig, remat: str = "none"):
        self.cfg = cfg
        self.remat = remat
        self.dtype = _dtype(cfg.param_dtype)
        self._pos_tables = {}  # (device, dtype) -> the decoder's (65536, D) table

    def _enc_layer_init(self, gen, dev):
        cfg = self.cfg
        return {
            "ln1": torch.zeros((cfg.d_model,), dtype=self.dtype, device=dev),
            "attn": attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                              self.dtype, device=dev),
            "ln2": torch.zeros((cfg.d_model,), dtype=self.dtype, device=dev),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp, self.dtype, device=dev),
        }

    def _dec_layer_init(self, gen, dev):
        cfg = self.cfg
        p = self._enc_layer_init(gen, dev)
        p["ln_x"] = torch.zeros((cfg.d_model,), dtype=self.dtype, device=dev)
        p["xattn"] = attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                               self.dtype, device=dev)
        return p

    def init(self, generator=None, device=None):
        """Random params from ``generator`` (default: seed 0 on the device)."""
        cfg = self.cfg
        dev = pick_device(device)
        gen = _generator(generator, dev)
        enc = [self._enc_layer_init(gen, dev) for _ in range(cfg.n_encoder_layers)]
        embed = init_dense(gen, (cfg.vocab, cfg.d_model), self.dtype, device=dev)
        dec = [self._dec_layer_init(gen, dev) for _ in range(cfg.n_layers)]
        return {
            "enc_layers": enc,
            "enc_norm": torch.zeros((cfg.d_model,), dtype=self.dtype, device=dev),
            "embed": embed,
            "dec_layers": dec,
            "final_norm": torch.zeros((cfg.d_model,), dtype=self.dtype, device=dev),
            "unembed": init_dense(gen, (cfg.d_model, cfg.vocab), self.dtype, device=dev),
        }

    def _enc_layer(self, p, h):
        cfg = self.cfg
        a, _ = attn_apply(p["attn"], rmsnorm(h, p["ln1"], cfg.norm_eps), causal=False)
        h = h + a
        return h + mlp_apply(p["mlp"], rmsnorm(h, p["ln2"], cfg.norm_eps), cfg.mlp)

    def encode(self, params, frames):
        cfg = self.cfg
        dev = params["enc_norm"].device
        frames = torch.as_tensor(frames, device=dev)
        h = frames.to(self.dtype) + _sinusoid(frames.shape[1], cfg.d_model, dev).to(self.dtype)
        layer = _checkpointed(self._enc_layer, self.remat)
        for p in params["enc_layers"]:
            h = layer(p, h)
        return rmsnorm(h, params["enc_norm"], cfg.norm_eps)

    def _positions(self, start, S, like):
        key = (like.device, like.dtype)
        if key not in self._pos_tables:
            self._pos_tables[key] = _sinusoid(_POS_ROWS, self.cfg.d_model, like.device).to(
                like.dtype)
        return self._pos_tables[key][start : start + S]

    def _dec_layer(self, p, h, enc_out, cache=None, cache_pos=None):
        cfg = self.cfg
        a, _ = attn_apply(p["attn"], rmsnorm(h, p["ln1"], cfg.norm_eps),
                          causal=True, cache=cache, cache_pos=cache_pos)
        h = h + a
        x, _ = attn_apply(p["xattn"], rmsnorm(h, p["ln_x"], cfg.norm_eps),
                          causal=False, kv_x=enc_out)
        h = h + x
        return h + mlp_apply(p["mlp"], rmsnorm(h, p["ln2"], cfg.norm_eps), cfg.mlp)

    def _decoder(self, params, h, enc_out, caches=None, cache_pos=None):
        start = 0 if cache_pos is None else cache_pos
        h = h + self._positions(start, h.shape[1], h)
        if caches is None:
            layer = _checkpointed(self._dec_layer, self.remat)
            for p in params["dec_layers"]:
                h = layer(p, h, enc_out)
            return h
        for i, p in enumerate(params["dec_layers"]):
            c = {"k": caches["k"][i], "v": caches["v"][i]}
            h = self._dec_layer(p, h, enc_out, cache=c, cache_pos=cache_pos)
        return h

    def _logits(self, params, h):
        # no vocab-shard hint here, as the reference (its H2b finding)
        return rmsnorm(h, params["final_norm"], self.cfg.norm_eps) @ params["unembed"]

    def loss(self, params, batch):
        """(ce, {"ce", "aux": 0.0}), differentiable in the params."""
        enc_out = self.encode(params, batch["frames"])
        h = _embed(params, batch["tokens"])
        h = self._decoder(params, h, enc_out)
        targets = torch.as_tensor(batch["targets"], device=h.device).long()
        ce = cross_entropy(self._logits(params, h), targets)
        return ce, {"ce": ce, "aux": 0.0}

    def init_cache(self, batch_size: int, max_len: int, device=None):
        cfg = self.cfg
        dev = pick_device(device)
        shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.hd)
        return cache_hint({"k": torch.zeros(shape, dtype=self.dtype, device=dev),
                           "v": torch.zeros(shape, dtype=self.dtype, device=dev)})

    def prefill(self, params, batch):
        """Encodes ``batch["frames"]`` and prefills the decoder's cache of
        ``batch["max_len"]`` (default: the prompt's length) positions."""
        with torch.inference_mode():
            tokens = batch["tokens"]
            B, S = tokens.shape
            enc_out = self.encode(params, batch["frames"])
            h = _embed(params, tokens)
            kv = self.init_cache(B, batch.get("max_len", S), device=h.device)
            h = self._decoder(params, h, enc_out, caches=kv, cache_pos=0)
            logits = self._logits(params, h[:, -1:])
        return logits[:, 0], {"kv": kv, "enc": enc_out, "pos": S}

    def decode_step(self, params, cache, tokens):
        with torch.inference_mode():
            h = _embed(params, tokens)
            h = self._decoder(params, h, cache["enc"], caches=cache["kv"], cache_pos=cache["pos"])
            logits = self._logits(params, h)
        return logits[:, 0], {"kv": cache["kv"], "enc": cache["enc"],
                              "pos": cache["pos"] + tokens.shape[1]}

    def decode_state(self, batch_size: int, max_len: int, device=None):
        cfg = self.cfg
        dev = pick_device(device)
        return {
            "kv": self.init_cache(batch_size, max_len, device=dev),
            "enc": torch.zeros((batch_size, cfg.encoder_seq, cfg.d_model), dtype=self.dtype,
                               device=dev),
            "pos": max_len - 1,
        }
