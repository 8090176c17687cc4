"""Architecture configuration schema + registry.

Every assigned architecture gets one module defining an ArchConfig with the
exact published hyper-parameters, plus a reduced `smoke()` variant of the
same family for CPU tests. `--arch <id>` resolves through REGISTRY.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden width
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMCfg:  # mamba2 (zamba2's mixer)
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    mlp: str = "swiglu"  # swiglu | geglu | gelu | sq_relu | none
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    # attention pattern
    window: Optional[int] = None  # sliding-window size for local layers
    global_every: int = 0  # gemma3: one global layer per `global_every` (6 -> 5:1)
    rope_base: float = 1e4
    rope_base_global: Optional[float] = None
    # hybrid (zamba2): one *shared* attn+mlp block applied every k mixer layers
    shared_attn_every: int = 0
    # enc-dec (whisper)
    n_encoder_layers: int = 0
    encoder_seq: int = 0  # stub-frontend frames presented to the encoder
    # vlm (llava): patch embeddings prepended by the stub frontend
    n_patches: int = 0
    # xlstm
    slstm_every: int = 0  # one sLSTM block per k blocks (rest mLSTM)
    # numerics / misc
    act_dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    moment_dtype: str = "float32"  # optimizer moments (bf16 for the largest)
    sub_quadratic: bool = False  # True -> long_500k decode supported
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # layers implemented with a python loop instead of scan-over-layers
    unrolled: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        hd = self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.family == "ssm":  # xlstm: internal projections approx 8 d^2
            per_layer = 8 * d * d
        else:
            if self.moe is not None:
                ff = self.moe.n_experts * (3 * d * self.moe.d_ff) + d * self.moe.n_experts
            elif self.mlp in ("swiglu", "geglu"):
                ff = 3 * d * self.d_ff
            elif self.mlp == "none":
                ff = 0
            else:
                ff = 2 * d * self.d_ff
            per_layer = attn + ff if self.shared_attn_every == 0 else 0
            if self.ssm is not None:  # mamba2 mixer
                d_in = self.ssm.expand * d
                per_layer = 2 * d * d_in + d_in * d + d_in * 2 * self.ssm.d_state
        total = emb + self.n_layers * per_layer
        if self.shared_attn_every:
            total += attn + 3 * d * self.d_ff  # the single shared block
        if self.n_encoder_layers:
            total += self.n_encoder_layers * (attn + 2 * d * self.d_ff)
            total += self.n_layers * attn  # decoder cross-attention
        return int(total)

    def active_params(self) -> int:
        """Active parameters per token (MoE uses top_k of n_experts)."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        dense = self.n_params() - self.n_layers * self.moe.n_experts * 3 * d * self.moe.d_ff
        return int(dense + self.n_layers * self.moe.top_k * 3 * d * self.moe.d_ff)


# registry: name -> (full_config_fn, smoke_config_fn)
REGISTRY: Dict[str, Tuple[Callable[[], ArchConfig], Callable[[], ArchConfig]]] = {}


def register(name: str, full: Callable[[], ArchConfig], smoke: Callable[[], ArchConfig]):
    REGISTRY[name] = (full, smoke)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    import repro_torch.configs.all_archs  # noqa: F401  (populates REGISTRY)

    full, sm = REGISTRY[name]
    return sm() if smoke else full()


def list_archs():
    import repro_torch.configs.all_archs  # noqa: F401

    return sorted(REGISTRY.keys())
