"""qwen2.5-32b — 64L d5120 40H (GQA kv=8) ff27648 v152064, QKV bias
[hf:Qwen/Qwen2.5-*; hf]. Counterpart of
`repro.configs.qwen2_5_32b`."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=27648,
    vocab_size=152064, act="silu", qkv_bias=True, rope_theta=1e6,
    sharding_profile="fsdp_sp",  # 40 heads do not divide the 16-way TP axis
)

REDUCED = ModelConfig(
    name="qwen2.5-32b-reduced", family="dense",
    n_layers=2, d_model=80, n_heads=5, n_kv_heads=1, d_ff=160,
    vocab_size=256, act="silu", qkv_bias=True,
    remat="none", compute_dtype="float32",
)
