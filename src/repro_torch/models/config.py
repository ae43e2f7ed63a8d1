"""Model/shape configuration schema for the architecture zoo.

Counterpart of `repro.models.config`, kept as a copy so the port never imports
the JAX package. One frozen dataclass describes every assigned architecture;
family-specific sub-configs (MoE, MLA, SSM, RWKV, enc-dec, vision-stub) are
attached where the arch needs them. `ShapeSpec` describes the assigned
input-shape cells (train_4k / prefill_32k / decode_32k / long_500k).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int                 # routed experts
    top_k: int
    expert_d_ff: int               # per-expert intermediate size
    n_shared_experts: int = 0      # deepseek-style always-on experts
    first_dense_layers: int = 0    # leading layers that use a dense MLP
    dense_d_ff: int = 0            # d_ff of those dense layers (0 -> expert_d_ff)
    capacity_factor: float = 1.25  # dense-dispatch buffer slack
    router_aux_weight: float = 0.01  # load-balance auxiliary loss weight


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention (compressed KV)."""
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block parameters."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64             # SSD head dimension P
    n_groups: int = 1
    chunk_size: int = 128


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64             # K/V head size of the wkv state
    decay_lora_rank: int = 64      # data-dependent decay LoRA (RWKV6 "Finch")
    ffn_mult: float = 3.5


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """zamba2-style shared attention block applied every `period` SSM layers."""
    period: int = 6
    lora_rank: int = 128           # per-invocation LoRA on the shared block


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int = 4
    # encoder input: precomputed frame embeddings (conv frontend is a stub per
    # the assignment); enc_len(seq_len) below maps the cell seq to frames.
    enc_len_ratio: float = 1.0


@dataclasses.dataclass(frozen=True)
class VisionStubConfig:
    """phi-3-vision: CLIP frontend stubbed; projector consumes patch embeds."""
    n_image_tokens: int = 576
    clip_dim: int = 1024


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    act: str = "silu"              # silu | gelu  (gated MLP unless mlp_gated=False)
    mlp_gated: bool = True
    norm: str = "rmsnorm"          # rmsnorm | layernorm | nonparam_ln
    qk_norm: bool = False          # qwen3
    qkv_bias: bool = False         # qwen2.5
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # mixtral SWA
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    # family-specific
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vision: Optional[VisionStubConfig] = None
    # long-context eligibility: True when attention cost/cache is sub-quadratic
    subquadratic: bool = False
    # execution knobs (hillclimbed in EXPERIMENTS §Perf)
    # "tp": TP activations (heads/d_ff on the model axis);
    # "fsdp_sp": pure FSDP weights + sequence-sharded activations — used when
    # head/ff counts do not divide the model axis (qwen2.5's 40 heads on 16).
    sharding_profile: str = "tp"
    # cast weights to bf16 BEFORE the FSDP all-gathers (shard-local cast) —
    # halves weight-streaming collective bytes; grads cross the cast boundary
    # in bf16 too (EXPERIMENTS §Perf measures the delta per cell)
    weight_stream_bf16: bool = False
    scan_layers: bool = True
    remat: str = "full"            # none | full | dots
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline sanity)."""
        from repro_torch.models.registry import analytic_param_count
        return analytic_param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models.registry import analytic_param_count
        return analytic_param_count(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# The assigned LM-family shape set (identical across the 10 archs).
SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Cell applicability per the assignment rules (skips recorded, not hidden)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full quadratic attention — long_500k skipped per assignment"
    return True, ""
