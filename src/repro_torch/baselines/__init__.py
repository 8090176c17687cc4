"""Baselines the paper compares against (Table 1 / Fig 2), on the port.

perceptron   — Rosenblatt, single pass (kernel P1 on the card).
pegasos      — Shalev-Shwartz et al. 2007 stochastic subgradient, single sweep,
               block size k (paper used k=1 and k=20; kernel P2 on the card).
lasvm        — Bordes et al. 2005 online SMO with PROCESS/REPROCESS, linear
               kernel, single pass; float64, the support set on the device.
cvm          — Tsang et al. 2005 core-vector machine: batch Badoiu-Clarkson
               core-set MEB in the same augmented space; one data pass per
               core vector (Fig 2's x-axis); float64 on the device.
batch_l2svm  — full-batch solver of the identical l2-SVM primal (the "libSVM
               batch mode" reference column; libSVM itself is unavailable
               offline — same objective, solved to tolerance).

Every entry point takes ``device=None``, meaning CUDA; a CPU tensor or
``device="cpu"`` runs on the CPU (the kernels' plain versions there).
"""
from .perceptron import fit_perceptron
from .pegasos import fit_pegasos
from .lasvm import fit_lasvm
from .cvm import fit_cvm
from .batch_l2svm import fit_batch_l2svm

__all__ = [
    "fit_perceptron",
    "fit_pegasos",
    "fit_lasvm",
    "fit_cvm",
    "fit_batch_l2svm",
]
