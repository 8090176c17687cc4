"""Import side-effect module: populates the REGISTRY with all 10 archs."""
from . import (  # noqa: F401
    nemotron_4_340b,
    internlm2_1_8b,
    granite_34b,
    gemma3_27b,
    qwen3_moe_235b_a22b,
    qwen3_moe_30b_a3b,
    llava_next_mistral_7b,
    zamba2_1_2b,
    whisper_base,
    xlstm_125m,
)
