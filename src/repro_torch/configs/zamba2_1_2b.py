"""zamba2-1.2b — 38 Mamba2 layers d2048 (ssm_state=64) + shared attention
block (32H kv=32, GLU ff8192) every 6 layers with per-invocation LoRA
[arXiv:2411.15242; hf]. Counterpart of `repro.configs.zamba2_1_2b`."""
from repro_torch.models.config import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32000, act="gelu", subquadratic=True,  # SSM state + few attn caches
    sharding_profile="fsdp_sp",
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1),
    hybrid=HybridConfig(period=6, lora_rank=128),
)

REDUCED = ModelConfig(
    name="zamba2-1.2b-reduced", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, act="gelu", subquadratic=True,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1,
                  chunk_size=8),
    hybrid=HybridConfig(period=2, lora_rank=8),
    remat="none", compute_dtype="float32",
)
