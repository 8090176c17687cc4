"""The port's kernels: hand-written CUDA C++ for Hopper, each beside its
plain PyTorch version.

streamsvm_scan — B1, one pass of Algorithm 1 for a bank of models over a
                 shared stream (csrc/streamsvm_scan.cu)
predict        — B2, queries x bank margins with the fused scores / ovr /
                 topk epilogues (csrc/predict.cu)

ops.py carries the public wrappers (padding, bank tiling, dtype policy);
_build.py compiles csrc/ with nvcc at first use.
"""
from .ops import predict_bank, streamsvm_fit_many

__all__ = ["predict_bank", "streamsvm_fit_many"]
