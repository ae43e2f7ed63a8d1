from repro_torch.data.pipeline import PipelineConfig, TokenPipeline  # noqa: F401
from repro_torch.data.synthetic import TokenTask  # noqa: F401
