"""Qwen3-MoE 30B-A3B [hf:Qwen/Qwen3-30B-A3B]: 128 experts, top-8."""
from .base import ArchConfig, MoECfg, register


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=768, vocab=151936, mlp="swiglu",
        moe=MoECfg(n_experts=128, top_k=8, d_ff=768),
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-30b-a3b-smoke", family="moe",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=64, vocab=512, mlp="swiglu",
        moe=MoECfg(n_experts=8, top_k=2, d_ff=64),
    )


register("qwen3-moe-30b-a3b", full, smoke)
