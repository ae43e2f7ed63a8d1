"""deepseek-v2-lite-16b — 27L d2048 16H MLA(kv_lora=512) v102400, 64 routed
top-6 + 2 shared experts, first layer dense [arXiv:2405.04434; hf].

The assignment line lists both "64e top-6" and "160 routed"; HF's V2-Lite is
64 routed + 2 shared (160 is full V2) — we implement the Lite config
(DESIGN.md §4 notes the discrepancy). Counterpart of
`repro.configs.deepseek_v2_lite_16b`."""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=102400, act="silu",
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, expert_d_ff=1408, n_shared_experts=2,
                  first_dense_layers=1, dense_d_ff=10944),
)

REDUCED = ModelConfig(
    name="deepseek-v2-lite-16b-reduced", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
    vocab_size=256, act="silu",
    mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                  v_head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=96, n_shared_experts=1,
                  first_dense_layers=1, dense_d_ff=192),
    remat="none", compute_dtype="float32",
)
