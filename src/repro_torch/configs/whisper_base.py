"""Whisper base [arXiv:2212.04356]: enc-dec; conv audio frontend is a STUB —
input_specs() provides precomputed frame embeddings (encoder_seq x d_model)."""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="whisper-base", family="encdec",
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
        d_ff=2048, vocab=51865, mlp="gelu",
        n_encoder_layers=6, encoder_seq=1500, unrolled=True,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="whisper-base-smoke", family="encdec",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=512, mlp="gelu",
        n_encoder_layers=2, encoder_seq=64, unrolled=True,
    )


register("whisper-base", full, smoke)
