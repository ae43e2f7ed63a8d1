from repro_torch.data.mmap_dataset import MmapTokenDataset  # noqa: F401
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline  # noqa: F401
from repro_torch.data.synthetic import ClassificationTask, TokenTask  # noqa: F401
