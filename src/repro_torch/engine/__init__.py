"""repro_torch.engine: the execution API over training schedules (counterpart
of `repro.engine`): the fused executor (Form A, meshless or sharded over a
mesh of ranks), the lane executors of Form B (`HeteroExecutor`,
`RemoteExecutor`), the elastic wrapper (`ElasticExecutor`), the numerics
guard's wrapper (`GuardedExecutor`, outermost), and the Engine with its
logging, throughput, eval, checkpoint and staleness callbacks."""
from repro_torch.engine.api import (  # noqa: F401
    ENGINE_METRIC_KEYS,
    ENGINE_OPTIONAL_METRIC_KEYS,
    FitReport,
    cost_analysis_dict,
    ensure_metric_contract,
    mesh_context,
    scalar_metrics,
)
from repro_torch.engine.callbacks import (  # noqa: F401
    Callback,
    CheckpointCallback,
    EvalCallback,
    LoggingCallback,
    StalenessTelemetry,
    ThroughputMeter,
)
from repro_torch.engine.elastic import ElasticExecutor  # noqa: F401
from repro_torch.engine.engine import Engine  # noqa: F401
from repro_torch.engine.fused import FusedExecutor  # noqa: F401
from repro_torch.engine.hetero import HeteroExecutor  # noqa: F401
from repro_torch.engine.remote import RemoteExecutor  # noqa: F401
from repro_torch.runtime.async_executor import AsyncSamExecutor, ExecutorConfig  # noqa: F401
from repro_torch.runtime.guard import GuardConfig, GuardedExecutor  # noqa: F401
