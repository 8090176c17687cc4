"""Gemma-3 27B [hf:google/gemma-3]: 5:1 local(window 1024):global, GeGLU,
dual RoPE bases (10k local / 1M global), decoupled head_dim."""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="gemma3-27b", family="dense",
        n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
        d_ff=21504, vocab=262144, mlp="geglu",
        window=1024, global_every=6, rope_base=1e4, rope_base_global=1e6,
        tie_embeddings=True,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="gemma3-27b-smoke", family="dense",
        n_layers=6, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, mlp="geglu",
        window=16, global_every=3, rope_base=1e4, rope_base_global=1e6,
        tie_embeddings=True,
    )


register("gemma3-27b", full, smoke)
