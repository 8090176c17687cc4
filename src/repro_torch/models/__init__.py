"""The LLM zoo's models on PyTorch: the dense, moe and vlm decoder
(``DecoderLM``) and xLSTM (``XLSTMModel``), built from a config by
``build_model``. Zamba2 and Whisper are not ported yet (ROADMAP A14)."""
from .model import build_model

__all__ = ["build_model"]
