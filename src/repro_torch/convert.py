"""Carry ball state between numpy (and anything numpy can read) and the port.

``ball_from_numpy`` takes any object with ``w, r, xi2, m`` attributes, or a
4-tuple ``(w, r, xi2, m)``, and returns a port ``Ball`` on ``device``;
``ball_to_numpy`` goes the other way. ``kernel_bank_from_numpy`` and
``kernel_bank_to_numpy`` do the same for a KernelBank's 7 leaves.
``lm_params_from_numpy`` and ``lm_params_to_numpy`` carry an LLM zoo model's
parameter tree. The tests use these to hand the JAX reference's state to the
port and back, through numpy arrays only.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import pick_device
from .core.kernel_bank import KernelBank
from .core.meb import Ball


def ball_from_numpy(obj, device=None) -> Ball:
    """A port ``Ball`` (w, r, xi2 float32; m int32) on ``device`` (None: CUDA)."""
    parts = (obj.w, obj.r, obj.xi2, obj.m) if hasattr(obj, "w") else tuple(obj)
    if len(parts) != 4:
        raise ValueError(f"a ball has 4 leaves (w, r, xi2, m); got {len(parts)}")
    dev = pick_device(device)
    w, r, xi2, m = (np.asarray(p) for p in parts)
    return Ball(
        w=torch.as_tensor(w.astype(np.float32), device=dev),
        r=torch.as_tensor(r.astype(np.float32), device=dev),
        xi2=torch.as_tensor(xi2.astype(np.float32), device=dev),
        m=torch.as_tensor(m.astype(np.int32), device=dev),
    )


def ball_to_numpy(ball: Ball) -> tuple:
    """``(w, r, xi2, m)`` as host numpy arrays."""
    return tuple(x.detach().cpu().numpy() for x in ball)


_KB_DTYPES = (np.int32, np.float32, np.float32, np.float32, np.float32, np.float32, np.int32)


def kernel_bank_from_numpy(obj, device=None) -> KernelBank:
    """A port ``KernelBank`` on ``device`` (None: CUDA) from any object with
    its 7 fields (idx, coef, points, q, r, xi2, m), or a 7-tuple of arrays;
    idx and m int32, the rest float32."""
    fields = KernelBank._fields
    parts = tuple(getattr(obj, f) for f in fields) if hasattr(obj, "coef") else tuple(obj)
    if len(parts) != len(fields):
        raise ValueError(f"a KernelBank has 7 leaves {fields}; got {len(parts)}")
    dev = pick_device(device)
    return KernelBank(*(
        torch.as_tensor(np.asarray(p).astype(dt), device=dev) for p, dt in zip(parts, _KB_DTYPES)
    ))


def kernel_bank_to_numpy(bank: KernelBank) -> tuple:
    """The 7 leaves ``(idx, coef, points, q, r, xi2, m)`` as host numpy arrays."""
    return tuple(x.detach().cpu().numpy() for x in bank)


def lm_params_from_numpy(cfg, tree, device=None):
    """The port's parameter tree for ``build_model(cfg)`` from the
    reference's, read as numpy arrays (``jax.tree.map(np.asarray, params)``).

    The tree is a dict for ``DecoderLM``, its ``layers`` stacked ``(L, ...)``
    leaves when ``cfg.unrolled`` is false and a list of per-layer dicts when
    it is true; for ``XLSTMModel`` its ``blocks`` are a list of mLSTM and
    sLSTM dicts; for ``Zamba2Model`` ``mamba`` is a list of per-layer dicts
    (``ln``, ``mix``) beside the ``shared`` block's dict; for
    ``EncDecModel`` ``enc_layers`` and ``dec_layers`` are lists of
    per-layer dicts. Each leaf must have the shape of the port's own init and
    takes its dtype. bf16 arrays (dtype name ``bfloat16``) are carried bit
    for bit through an int16 view; float32 arrays are cast.
    """
    from .models import build_model

    dev = pick_device(device)
    template = build_model(cfg).init(device="meta")

    def leaf(want, got, path):
        got = np.require(got, requirements=["C", "W"])  # copies a read-only (JAX) array
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"{path}: shape {got.shape}, the port's {tuple(want.shape)}")
        if got.dtype.name == "bfloat16":
            t = torch.from_numpy(got.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(got)
        return t.to(device=dev, dtype=want.dtype, copy=True)  # never aliases the caller's array

    def walk(want, got, path):
        if isinstance(want, dict):
            if set(got) != set(want):
                raise ValueError(f"{path}: keys {sorted(got)}, the port's {sorted(want)}")
            return {k: walk(want[k], got[k], f"{path}.{k}") for k in want}
        if isinstance(want, list):
            if not isinstance(got, (list, tuple)) or len(got) != len(want):
                raise ValueError(f"{path}: expected a list of {len(want)} entries")
            return [walk(w, g, f"{path}[{i}]") for i, (w, g) in enumerate(zip(want, got))]
        return leaf(want, got, path)

    return walk(template, tree, "params")


def lm_params_to_numpy(params):
    """The port's parameter tree as host numpy arrays, the same nesting; bf16
    leaves come back as float32 (exact), since numpy has no bfloat16."""
    if isinstance(params, dict):
        return {k: lm_params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [lm_params_to_numpy(v) for v in params]
    t = params.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
