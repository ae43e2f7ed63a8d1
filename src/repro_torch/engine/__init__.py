"""repro_torch.engine: the execution API over training schedules (counterpart
of `repro.engine`). Ported: the fused executor (Form A, meshless), the lane
executors of Form B (`HeteroExecutor`, `RemoteExecutor`), and the Engine
with its logging, throughput, checkpoint and staleness callbacks."""
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
    StalenessTelemetry,
    ThroughputMeter,
)
from repro_torch.engine.engine import Engine  # noqa: F401
from repro_torch.engine.fused import FusedExecutor  # noqa: F401
from repro_torch.engine.hetero import HeteroExecutor  # noqa: F401
from repro_torch.engine.remote import RemoteExecutor  # noqa: F401
