"""The LLM zoo's models on PyTorch, built from a config by ``build_model``:
the dense, moe and vlm decoder (``DecoderLM``), Zamba2 (``Zamba2Model``),
xLSTM (``XLSTMModel``) and Whisper (``EncDecModel``)."""
from .model import build_model

__all__ = ["build_model"]
