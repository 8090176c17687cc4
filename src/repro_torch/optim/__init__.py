"""Optimizers of the LLM zoo's training path (the port of the reference's
``optim/``): AdamW, the warmup-cosine schedule and gradient compression."""
from . import adamw, grad_compress, schedule

__all__ = ["adamw", "grad_compress", "schedule"]
