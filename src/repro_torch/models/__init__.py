from repro_torch.models.config import (  # noqa: F401
    SHAPES,
    EncDecConfig,
    HybridConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    RWKVConfig,
    ShapeSpec,
    SSMConfig,
    VisionStubConfig,
    shape_applicable,
)
from repro_torch.models.registry import (  # noqa: F401
    ModelBundle,
    analytic_param_count,
    batch_spec,
    build_model,
    cache_spec,
    cross_entropy,
    decode_batch_spec,
    synth_batch,
)
