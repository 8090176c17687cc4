"""Meta-tensor stand-ins for every model input (no allocation).

The port of the reference's ``launch/specs.py``: tensors on the meta device
take the place of ``ShapeDtypeStruct``. Together with ``model.init`` and
``model.decode_state`` on the meta device they let the dry run lay out
every (arch x shape x mesh) cell without materialising a weight. The VLM and
audio frontends are stubs: ``image_embeds`` and ``frames`` are
precomputed-embedding inputs.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSpec

META = torch.device("meta")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((B, S), torch.int32), "targets": _meta((B, S), torch.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = _meta((B, cfg.n_patches, cfg.d_model), torch.bfloat16)
    if cfg.family == "encdec":
        batch["frames"] = _meta((B, cfg.encoder_seq, cfg.d_model), torch.float32)
    return batch


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    batch = train_batch_specs(cfg, shape)
    batch.pop("targets")
    return batch


def decode_specs(model, cfg: ArchConfig, shape: ShapeSpec):
    """(cache, tokens): one new token against a seq_len cache."""
    B, S = shape.global_batch, shape.seq_len
    return model.decode_state(B, S, device=META), _meta((B, 1), torch.int32)


def params_specs(model):
    return model.init(device=META)
