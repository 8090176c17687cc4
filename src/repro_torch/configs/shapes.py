"""Assigned input-shape specs and (arch x shape) applicability rules."""
from __future__ import annotations

import dataclasses
from typing import List

from .base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

SMOKE_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 64, 2),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 128, 2),
    "decode_32k": ShapeSpec("decode_32k", "decode", 128, 2),
    "long_500k": ShapeSpec("long_500k", "decode", 256, 1),
}


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(is_applicable, reason-if-not). Skip rules from the assignment:

    - long_500k needs sub-quadratic attention: run only for SSM/hybrid
      archs (zamba2, xlstm); skip for pure full-attention archs (gemma3's
      global layers are full attention, so it is skipped too).
    - encoder-only archs would skip decode shapes — none assigned here
      (whisper has a decoder).
    """
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 512k dense KV decode skipped per assignment"
    return True, ""


def cells(cfgs: List[ArchConfig]):
    """All (arch, shape) cells with applicability annotations."""
    out = []
    for cfg in cfgs:
        for shape in SHAPES.values():
            ok, why = applicable(cfg, shape)
            out.append((cfg, shape, ok, why))
    return out
