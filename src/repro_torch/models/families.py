"""Model classes beyond the decoder-only transformer, with DecoderLM's API
(init / loss / prefill / decode_step / init_cache / decode_state).

The port of the reference's ``models/families.py``: ``XLSTMModel`` (the ssm
family; ``loss`` is differentiable, and ``remat`` other than ``"none"``
checkpoints each block of a differentiable forward, as the reference's
``jax.checkpoint``). ``Zamba2Model`` (hybrid) and ``EncDecModel`` (encdec)
are not ported yet (ROADMAP A14) and raise on construction.
"""
from __future__ import annotations

import torch

from repro_torch._device import pick_device
from repro_torch.configs.base import ArchConfig
from .layers import cross_entropy, init_dense, rmsnorm
from .transformer import _dtype, _generator, remat_layer
from .xlstm import mlstm_block, mlstm_init, slstm_block, slstm_init


class Zamba2Model:
    def __init__(self, cfg: ArchConfig, remat: str = "none"):
        raise NotImplementedError(
            "A14: Zamba2 (models/mamba2.py and Zamba2Model) is not ported yet")


class EncDecModel:
    def __init__(self, cfg: ArchConfig, remat: str = "none"):
        raise NotImplementedError("A14: Whisper (EncDecModel) is not ported yet")


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

    def _embed(self, params, tokens):
        emb = params["embed"]
        return emb[torch.as_tensor(tokens, device=emb.device).long()]

    def _forward(self, params, h, states=None):
        cfg = self.cfg
        new_states = []
        remat = self.remat if states is None and torch.is_grad_enabled() else "none"
        slstm, mlstm = (remat_layer(b, "full" if remat != "none" else "none")
                        for b in (slstm_block, mlstm_block))
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
        return rmsnorm(h, params["final_norm"], self.cfg.norm_eps) @ params["unembed"]

    def loss(self, params, batch):
        """(ce, {"ce", "aux": 0.0}), differentiable in the params."""
        h = self._embed(params, batch["tokens"])
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
        return states

    def prefill(self, params, batch):
        with torch.inference_mode():
            tokens = batch["tokens"]
            B, S = tokens.shape
            h = self._embed(params, tokens)
            states = self.init_cache(B, 0, device=h.device)
            h, states = self._forward(params, h, states=states)
            logits = self._logits(params, h[:, -1:])
        return logits[:, 0], {"c": states, "pos": S}

    def decode_step(self, params, cache, tokens):
        with torch.inference_mode():
            h = self._embed(params, tokens)
            h, states = self._forward(params, h, states=cache["c"])
            logits = self._logits(params, h)
        return logits[:, 0], {"c": states, "pos": cache["pos"] + tokens.shape[1]}

    def decode_state(self, batch_size: int, max_len: int, device=None):
        # constant-size recurrent state: max_len only sets the position
        return {"c": self.init_cache(batch_size, 0, device=device), "pos": max_len - 1}
