"""gemma-2b — 18L d2048 8H MQA(kv=1) GeGLU ff16384 v256000, head_dim=256,
tied embeddings [arXiv:2403.08295; hf]. Counterpart of
`repro.configs.gemma_2b`."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab_size=256000, head_dim=256, act="gelu", tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="gemma-2b-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab_size=256, head_dim=32, act="gelu", tie_embeddings=True,
    remat="none", compute_dtype="float32",
)
