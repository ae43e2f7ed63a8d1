"""qwen3-8b — 36L d4096 32H (GQA kv=8) ff12288 v151936, qk_norm
[hf:Qwen/Qwen3-8B; hf]. Counterpart of
`repro.configs.qwen3_8b`."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12288,
    vocab_size=151936, head_dim=128, act="silu", qk_norm=True, rope_theta=1e6,
)

REDUCED = ModelConfig(
    name="qwen3-8b-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16, act="silu", qk_norm=True,
    remat="none", compute_dtype="float32",
)
