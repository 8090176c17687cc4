"""xLSTM 125M [arXiv:2405.04517]: mLSTM blocks with one sLSTM per 4 blocks.

d_ff=0 per assignment: blocks carry their own up/down projections, no
separate FFN. mLSTM trains with the parallel (stabilized) form, decodes with
the O(1) recurrent form; sLSTM is sequential in both (a loop over time).
"""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="xlstm-125m", family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
        d_ff=0, vocab=50304, mlp="none",
        slstm_every=4, sub_quadratic=True, unrolled=True,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="xlstm-125m-smoke", family="ssm",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=0, vocab=512, mlp="none",
        slstm_every=2, sub_quadratic=True, unrolled=True,
    )


register("xlstm-125m", full, smoke)
