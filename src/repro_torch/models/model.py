"""Model registry/dispatch: build_model(cfg) -> model object with the shared
API (init / loss / prefill / decode_step / init_cache / decode_state)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from .families import EncDecModel, XLSTMModel, Zamba2Model
from .transformer import DecoderLM


def build_model(cfg: ArchConfig, remat: str = "none"):
    """``remat`` is accepted and ignored: nothing of the port trains yet."""
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg, remat=remat)
    if cfg.family == "hybrid":
        return Zamba2Model(cfg, remat=remat)
    if cfg.family == "ssm":
        return XLSTMModel(cfg, remat=remat)
    if cfg.family == "encdec":
        return EncDecModel(cfg, remat=remat)
    raise ValueError(cfg.family)
