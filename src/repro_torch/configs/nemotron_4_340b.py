"""Nemotron-4 340B [arXiv:2402.16819]: dense GQA, squared-ReLU MLP."""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="nemotron-4-340b", family="dense",
        n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, head_dim=192,
        d_ff=73728, vocab=256000, mlp="sq_relu", rope_base=1e4,
        moment_dtype="bfloat16",  # 340B: fp32 moments would not fit 16G/chip
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="nemotron-4-340b-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab=512, mlp="sq_relu", rope_base=1e4,
    )


register("nemotron-4-340b", full, smoke)
