"""PyTorch/CUDA port of the one-pass StreamSVM system (the JAX package
``repro`` is its reference).

Subpackages mirror ``repro``: ``core`` (ball algebra, the bank, multiclass,
the streaming driver), ``kernels`` (hand-written CUDA kernels for Hopper,
each beside its plain PyTorch version), ``checkpoint`` and ``serve``. Every
entry point runs on CUDA unless the caller passes CPU tensors or
``device="cpu"``. This package imports torch and numpy only.
"""
