from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointIntegrityError,
    CheckpointManager,
)
