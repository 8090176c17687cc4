"""The port's kernels: hand-written CUDA C++ for Hopper, each beside its
plain PyTorch version.

streamsvm_scan — B1 and B3, one pass of Algorithm 1 / the fused
                 Algorithm 2 (lookahead) for a bank of models over a shared
                 stream (csrc/streamsvm_scan.cu); B4, Algorithm 1 for one
                 model (csrc/streamsvm_single.cu)
predict        — B2, queries x bank margins with the fused scores / ovr /
                 topk epilogues (csrc/predict.cu)
gram           — B5, a Gram block with the linear / RBF epilogue fused
                 (csrc/gram.cu)
kernel_bank    — R1, the kernelized bank's core-set row recursion over a
                 stream tile (csrc/kernel_bank.cu)
multiball      — M1, the Sec 4.3 multi-ball recursion of one model's L ball
                 slots over a stream (csrc/multiball.cu)
baselines      — P1, the perceptron, and P2, Pegasos, the paper's
                 baselines' recursions: each B4's walk with its rule
                 (csrc/streamsvm_single.cu), and P2 at larger k a step
                 form (csrc/baselines.cu)
partings       — where a kernel's run first parts from its plain
                 version's, and whether that is an f32 tie

ops.py carries the public wrappers (padding, bank tiling, dtype policy);
_build.py compiles csrc/ with nvcc at first use.
"""
from .ops import gram, predict_bank, predict_kernel_bank, streamsvm_fit, streamsvm_fit_many

__all__ = ["gram", "predict_bank", "predict_kernel_bank", "streamsvm_fit", "streamsvm_fit_many"]
