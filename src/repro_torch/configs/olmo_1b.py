"""olmo-1b — 16L d2048 16H (kv=16) ff8192 v50304, non-parametric LayerNorm,
tied embeddings [arXiv:2402.00838; hf]. Counterpart of `repro.configs.olmo_1b`."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab_size=50304, act="silu", norm="nonparam_ln", tie_embeddings=True,
    # dots remat fits this model in HBM and removes the re-forward:
    # MFU-bound 0.49 -> 0.77 with AsyncSAM-k4 (EXPERIMENTS §Perf cell A)
    remat="dots",
)

REDUCED = ModelConfig(
    name="olmo-1b-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, act="silu", norm="nonparam_ln", tie_embeddings=True,
    remat="none", compute_dtype="float32",
)
