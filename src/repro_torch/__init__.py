"""PyTorch/CUDA port of the one-pass StreamSVM system (the JAX package
``repro`` is its reference).

Subpackages mirror ``repro``: ``core`` (ball algebra, Algorithms 1 and 2
for one model and for a bank, multiclass, the streaming drivers),
``kernels`` (hand-written CUDA kernels for Hopper, each beside its plain
PyTorch version), ``checkpoint``, ``serve``, ``runtime`` (restart loop,
retry policy, range re-issue), ``live`` (the always-on train -> fold ->
hot-swap loop) and ``data`` (numpy-only dataset generators and stream
helpers). Every entry point runs on CUDA
unless the caller passes CPU tensors or ``device="cpu"``. This package
imports torch and numpy only.
"""
