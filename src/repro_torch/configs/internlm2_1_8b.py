"""InternLM2 1.8B [arXiv:2403.17297]: llama-family dense GQA."""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="internlm2-1.8b", family="dense",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab=92544, mlp="swiglu",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="internlm2-1.8b-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, mlp="swiglu",
    )


register("internlm2-1.8b", full, smoke)
