"""repro_torch.engine: the execution API over training schedules (counterpart
of `repro.engine`). Ported: the fused executor (Form A, meshless) and the
Engine with its logging, throughput and checkpoint callbacks."""
from repro_torch.engine.api import (  # noqa: F401
    ENGINE_METRIC_KEYS,
    FitReport,
    ensure_metric_contract,
    scalar_metrics,
)
from repro_torch.engine.callbacks import (  # noqa: F401
    Callback,
    CheckpointCallback,
    LoggingCallback,
    ThroughputMeter,
)
from repro_torch.engine.engine import Engine  # noqa: F401
from repro_torch.engine.fused import FusedExecutor  # noqa: F401
