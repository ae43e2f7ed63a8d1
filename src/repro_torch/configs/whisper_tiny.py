"""whisper-tiny — enc-dec 4L d384 6H ff1536 v51865, conv frontend stubbed
(precomputed frame embeddings) [arXiv:2212.04356; unverified]. Counterpart of
`repro.configs.whisper_tiny`."""
from repro_torch.models.config import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
    vocab_size=51865, norm="layernorm", act="gelu", mlp_gated=False,
    tie_embeddings=True,
    encdec=EncDecConfig(n_encoder_layers=4, enc_len_ratio=1.0),
)

REDUCED = ModelConfig(
    name="whisper-tiny-reduced", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, norm="layernorm", act="gelu", mlp_gated=False,
    tie_embeddings=True,
    encdec=EncDecConfig(n_encoder_layers=2, enc_len_ratio=1.0),
    remat="none", compute_dtype="float32",
)
