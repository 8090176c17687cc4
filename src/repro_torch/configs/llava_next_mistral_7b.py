"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

The assignment specifies the transformer BACKBONE; the anyres vision tower is
a STUB — input_specs() provides precomputed patch embeddings (n_patches x
d_model) which replace the first n_patches token positions.
"""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="llava-next-mistral-7b", family="vlm",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=32000, mlp="swiglu", n_patches=576,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="llava-next-mistral-7b-smoke", family="vlm",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, mlp="swiglu", n_patches=16,
    )


register("llava-next-mistral-7b", full, smoke)
