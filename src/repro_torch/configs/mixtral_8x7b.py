"""mixtral-8x7b — 32L d4096 32H (GQA kv=8) ff14336 v32000, 8 experts top-2, SWA
[arXiv:2401.04088; hf]. Counterpart of
`repro.configs.mixtral_8x7b`."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, head_dim=128, act="silu", rope_theta=1e6,
    sliding_window=4096, subquadratic=True,  # SWA bounds the decode cache
    moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=14336),
)

REDUCED = ModelConfig(
    name="mixtral-8x7b-reduced", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16, act="silu", sliding_window=8, subquadratic=True,
    moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=128),
    remat="none", compute_dtype="float32",
)
