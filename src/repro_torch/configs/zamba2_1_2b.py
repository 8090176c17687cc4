"""Zamba2 1.2B [arXiv:2411.15242]: Mamba2 backbone + one shared attention
block applied every 6 mixer layers (weights shared across applications)."""
from .base import ArchConfig, SSMCfg, register


def full() -> ArchConfig:
    return ArchConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, vocab=32000, mlp="gelu",
        ssm=SSMCfg(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
        shared_attn_every=6, sub_quadratic=True, unrolled=True,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="zamba2-1.2b-smoke", family="hybrid",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=512, mlp="gelu",
        ssm=SSMCfg(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=32),
        shared_attn_every=2, sub_quadratic=True, unrolled=True,
    )


register("zamba2-1.2b", full, smoke)
