"""phi-3-vision-4.2b — 32L d3072 32H (kv=32) ff8192 v32064 backbone; CLIP
frontend stubbed (precomputed 576 patch embeddings @1024, learned projector)
[hf:microsoft/Phi-3-vision-128k-instruct; hf]. Counterpart of
`repro.configs.phi_3_vision_4_2b`."""
from repro_torch.models.config import ModelConfig, VisionStubConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32064, act="silu",
    vision=VisionStubConfig(n_image_tokens=576, clip_dim=1024),
)

REDUCED = ModelConfig(
    name="phi-3-vision-4.2b-reduced", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, act="silu",
    vision=VisionStubConfig(n_image_tokens=8, clip_dim=32),
    remat="none", compute_dtype="float32",
)
