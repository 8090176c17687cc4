"""Decoder-only transformer LM of the dense, moe and vlm families.

The port of the reference's ``models/transformer.py``. Uniform stacks keep
the reference's stacked per-layer params ((L, ...) leaves, indexed per layer
here where the reference scans), drawn layer by layer into preallocated
leaves; ``cfg.unrolled`` keeps a list of per-layer dicts. Per-layer
heterogeneity (gemma3's local/global pattern, dual RoPE bases) is a Python
int window and float base per layer. A moe config's layers hold ``"moe"``
(``models/moe.py``) in place of ``"mlp"``, and the loss adds 0.01 x the
layers' summed load-balancing aux.

API (shared by every model class in this package):
  init(generator=None, device=None) -> params
  loss(params, batch) -> (scalar, metrics)
  prefill(params, batch) -> (last_logits, cache)
  decode_step(params, cache, tokens) -> (logits, cache)
  init_cache(batch_size, max_len, device=None) -> cache

``loss`` is differentiable (``torch.autograd`` on the params, as
``train/train_loop.py`` takes it); ``remat`` checkpoints each layer of a
differentiable forward (``"none"`` saves every activation, ``"full"``
recomputes the whole layer in the backward pass, any other value keeps the
outputs of the products without batch dimensions and recomputes the rest,
the reference's ``dots_with_no_batch_dims_saveable``). ``prefill`` and
``decode_step`` run under ``torch.inference_mode()``. Everything runs on
the device of the params: CUDA unless they were made on the CPU
(``init(device="cpu")``). ``moe_stats``: set it to a list and each MoE
layer of a forward appends its capacity and dropped assignments
(``moe_apply``'s ``stats``).
"""
from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch._device import pick_device
from repro_torch._tree import map_tree
from repro_torch.configs.base import ArchConfig
from repro_torch.sharding.hints import cache_hint, shard_hint
from .layers import (
    attn_apply,
    attn_init,
    cross_entropy,
    init_dense,
    mlp_apply,
    mlp_init,
    rmsnorm,
)
from .moe import moe_apply, moe_init

_NO_WINDOW = 1 << 30

def _dtype(name: str):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _generator(generator, dev):
    """The generator ``init`` draws from: the caller's, or seed 0 on ``dev``
    (none on the meta device, which draws nothing)."""
    if dev.type == "meta":
        return None
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return generator


def _products_saved(ctx, op, *args, **kwargs):
    """Selective remat's policy: keep the outputs of products without batch
    dimensions (``mm``, ``addmm``, a ``bmm`` over a batch of one, as einsum
    forms them), recompute everything else (attention's and the experts'
    batched products too)."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat_layer(fn, remat: str):
    """``fn`` checkpointed as ``remat`` says (see the module's docstring)."""
    if remat == "none":
        return fn
    kw = {} if remat == "full" else {"context_fn": functools.partial(
        _ckpt.create_selective_checkpoint_contexts, _products_saved)}
    return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False, **kw)


class DecoderLM:
    def __init__(self, cfg: ArchConfig, remat: str = "none"):
        self.cfg = cfg
        self.remat = remat
        self.dtype = _dtype(cfg.param_dtype)
        self.moe_stats = None  # a list: each MoE layer appends its capacity and drops

    # -- params ------------------------------------------------------------
    def _layer_init(self, gen, dev):
        cfg = self.cfg
        p = {
            "ln1": torch.zeros((cfg.d_model,), dtype=self.dtype, device=dev),
            "attn": attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                              self.dtype, device=dev),
            "ln2": torch.zeros((cfg.d_model,), dtype=self.dtype, device=dev),
        }
        if cfg.moe is not None:
            p["moe"] = moe_init(gen, cfg.d_model, cfg.moe, self.dtype, device=dev)
        else:
            p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp, self.dtype, device=dev)
        return p

    def init(self, generator=None, device=None):
        """Random params from ``generator`` (default: seed 0 on the device).

        A uniform stack is drawn layer by layer into preallocated (L, ...)
        leaves, so only one layer's draws (and one leaf's f32 draw) are held
        beside the stack: the same bits as stacking per-layer dicts."""
        cfg = self.cfg
        dev = pick_device(device)
        gen = _generator(generator, dev)
        emb = init_dense(gen, (cfg.vocab, cfg.d_model), self.dtype, device=dev)
        if cfg.unrolled:
            layers = [self._layer_init(gen, dev) for _ in range(cfg.n_layers)]
        else:
            layers = None
            for i in range(cfg.n_layers):
                lp = self._layer_init(gen, dev)
                if layers is None:
                    layers = map_tree(lambda t: torch.empty(
                        (cfg.n_layers, *t.shape), dtype=t.dtype, device=dev), lp)
                map_tree(lambda dst, src: dst[i].copy_(src), layers, lp)
                del lp
        params = {
            "embed": emb,
            "layers": layers,
            "final_norm": torch.zeros((cfg.d_model,), dtype=self.dtype, device=dev),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = init_dense(gen, (cfg.d_model, cfg.vocab), self.dtype, device=dev)
        return params

    # -- per-layer meta (gemma3 local/global pattern) ------------------------
    def _layer_meta(self):
        """(windows, rope bases): a Python int and float per layer."""
        cfg = self.cfg
        base_g = cfg.rope_base_global if cfg.rope_base_global else cfg.rope_base
        windows, bases = [], []
        for i in range(cfg.n_layers):
            if cfg.global_every:
                is_global = (i + 1) % cfg.global_every == 0
            else:
                is_global = cfg.window is None
            local = cfg.window if cfg.window is not None else _NO_WINDOW
            windows.append(_NO_WINDOW if is_global else local)
            bases.append(float(base_g if is_global else cfg.rope_base))
        return windows, bases

    # -- blocks --------------------------------------------------------------
    def _block(self, p, x, window, rope_base, cache=None, cache_pos=None):
        cfg = self.cfg
        h, _ = attn_apply(
            p["attn"],
            rmsnorm(x, p["ln1"], cfg.norm_eps),
            rope_base=rope_base,
            causal=True,
            window=window,
            cache=cache,
            cache_pos=cache_pos,
        )
        x = x + h
        hin = rmsnorm(x, p["ln2"], cfg.norm_eps)
        if cfg.moe is not None:
            h2, aux = moe_apply(p["moe"], hin, cfg.moe, stats=self.moe_stats)
        else:
            h2, aux = mlp_apply(p["mlp"], hin, cfg.mlp), 0.0
        return x + h2, aux

    # -- forward -------------------------------------------------------------
    def _embed(self, params, batch):
        cfg = self.cfg
        emb = params["embed"]
        h = emb[torch.as_tensor(batch["tokens"], device=emb.device).long()]  # (B, S, D)
        if cfg.tie_embeddings:  # the scale rounded to h's dtype first, as the reference's
            h = h * torch.tensor(cfg.d_model**0.5, dtype=h.dtype).item()
        if cfg.family == "vlm" and "image_embeds" in batch:
            img = torch.as_tensor(batch["image_embeds"], device=h.device).to(h.dtype)
            h[:, : img.shape[1]] = img  # h is a fresh tensor (a gather, or its scaling)
        return h

    def _unembed(self, params, h):
        cfg = self.cfg
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        return shard_hint(h @ w, ("dp", None, "tp"))  # vocab-sharded logits

    def _stack(self, params, h, cache=None, cache_pos=None):
        """Run all layers. Returns (h, aux summed over the layers: 0.0 for a
        dense stack); a cache is written in place. A differentiable forward
        without a cache checkpoints each layer as ``remat`` says."""
        cfg = self.cfg
        windows, bases = self._layer_meta()
        layers = params["layers"]
        block = self._block
        if cache is None and torch.is_grad_enabled():
            block = remat_layer(self._block, self.remat)
        # sequence parallelism at the layer boundaries of the stacked layout
        # (not for MoE, whose dispatch wants tokens dp-sharded only)
        seq_par = cache is None and cfg.moe is None and not cfg.unrolled
        hint = (lambda x: shard_hint(x, ("dp", "tp", None))) if seq_par else (lambda x: x)
        aux = 0.0
        for i in range(cfg.n_layers):
            lp = layers[i] if cfg.unrolled else _layer(layers, i)
            if cache is None:
                h, a = block(lp, hint(h), windows[i], bases[i])
                h = hint(h)
            else:
                c = {"k": cache["k"][i], "v": cache["v"][i]}
                h, a = self._block(lp, h, windows[i], bases[i], cache=c, cache_pos=cache_pos)
            aux = aux + a
        return h, aux

    # -- public API ------------------------------------------------------------
    def loss(self, params, batch):
        """(ce + 0.01 x aux, {"ce", "aux"}), differentiable in the params."""
        h = self._embed(params, batch)
        h, aux = self._stack(params, h)
        logits = self._unembed(params, h)
        targets = torch.as_tensor(batch["targets"], device=logits.device).long()
        if self.cfg.family == "vlm" and "image_embeds" in batch:
            P = batch["image_embeds"].shape[1]
            pos = torch.arange(targets.shape[1], device=targets.device)[None, :]
            targets = torch.where(pos < P, -1, targets)
        ce = cross_entropy(logits, targets)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def init_cache(self, batch_size: int, max_len: int, device=None):
        cfg = self.cfg
        dev = pick_device(device)
        shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.hd)
        return cache_hint({
            "k": torch.zeros(shape, dtype=self.dtype, device=dev),
            "v": torch.zeros(shape, dtype=self.dtype, device=dev),
        })

    def prefill(self, params, batch):
        """Full forward building the cache; returns (last_logits, cache).
        ``batch["max_len"]`` (default: the prompt's length) sizes the cache."""
        with torch.inference_mode():
            tokens = batch["tokens"]
            B, S = tokens.shape
            h = self._embed(params, batch)
            kv = self.init_cache(B, batch.get("max_len", S), device=h.device)
            h, _ = self._stack(params, h, cache=kv, cache_pos=0)
            logits = self._unembed(params, h[:, -1:, :])
        return logits[:, 0, :], {"kv": kv, "pos": S}

    def decode_step(self, params, cache, tokens):
        """tokens: (B, 1). Returns (logits (B, V), cache).

        Consumes ``cache``: its buffers are written in place and returned in
        the new cache (the reference's callers donate it), so clone a cache
        that is still needed."""
        with torch.inference_mode():
            h = self._embed(params, {"tokens": tokens})
            h, _ = self._stack(params, h, cache=cache["kv"], cache_pos=cache["pos"])
            logits = self._unembed(params, h)
        return logits[:, 0, :], {"kv": cache["kv"], "pos": cache["pos"] + tokens.shape[1]}

    def decode_state(self, batch_size: int, max_len: int, device=None):
        """Full decode-time state (cache + position)."""
        return {"kv": self.init_cache(batch_size, max_len, device=device), "pos": max_len - 1}


def _layer(stacked, i):
    """Layer ``i``'s params as views of the (L, ...) leaves."""
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]
