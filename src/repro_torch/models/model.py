"""Model registry/dispatch: build_model(cfg) -> model object with the shared
API (init / loss / prefill / decode_step / init_cache / decode_state)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from .families import EncDecModel, XLSTMModel, Zamba2Model
from .transformer import DecoderLM


def build_model(cfg: ArchConfig, remat: str = "none"):
    """The model of ``cfg.family``. ``remat`` sets what a differentiable
    forward (``loss`` under autograd) keeps for the backward pass, per
    layer: ``"none"`` saves every activation; ``"full"`` saves only the
    layer's input and recomputes the layer; any other value (the reference
    names its policy ``dots_with_no_batch_dims_saveable``) saves the outputs
    of the products without batch dimensions and recomputes the rest
    (DecoderLM; Zamba2Model, XLSTMModel and EncDecModel recompute the whole
    layer for any value but ``"none"``, as the reference does). ``prefill`` and ``decode_step``
    never checkpoint."""
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg, remat=remat)
    if cfg.family == "hybrid":
        return Zamba2Model(cfg, remat=remat)
    if cfg.family == "ssm":
        return XLSTMModel(cfg, remat=remat)
    if cfg.family == "encdec":
        return EncDecModel(cfg, remat=remat)
    raise ValueError(cfg.family)
