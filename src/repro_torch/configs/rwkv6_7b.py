"""rwkv6-7b ("Finch") — 32L d4096 attention-free ff14336 v65536,
data-dependent decay [arXiv:2404.05892; hf]. Counterpart of
`repro.configs.rwkv6_7b`."""
from repro_torch.models.config import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, d_ff=14336,
    vocab_size=65536, norm="layernorm", subquadratic=True,
    rwkv=RWKVConfig(head_dim=64, decay_lora_rank=64),
)

REDUCED = ModelConfig(
    name="rwkv6-7b-reduced", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=224,
    vocab_size=256, norm="layernorm", subquadratic=True,
    rwkv=RWKVConfig(head_dim=16, decay_lora_rank=8),
    remat="none", compute_dtype="float32",
)
