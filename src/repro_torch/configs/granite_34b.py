"""Granite 34B code [arXiv:2405.04324]: dense, MQA (kv=1), 4x gelu MLP."""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="granite-34b", family="dense",
        n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
        d_ff=24576, vocab=49152, mlp="gelu",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="granite-34b-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
        d_ff=512, vocab=512, mlp="gelu",
    )


register("granite-34b", full, smoke)
