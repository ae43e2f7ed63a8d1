"""repro_torch.runtime: checkpoint-restart and the heterogeneous asynchronous
executor (counterpart of the `fault_tolerance` and `async_executor` parts of
`repro.runtime`). The reference's guard, health, chaos and elastic modules
are later slices (ROADMAP.md queue 1)."""
from repro_torch.runtime.async_executor import (  # noqa: F401
    AsyncSamExecutor,
    ExecutorConfig,
    LedgerOnlyLane,
    ThreadAscentLane,
    ascent_exchange,
)
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    InjectedFailure,
    PoisonBatch,
    ResilienceConfig,
    RestartBudget,
    RunReport,
    run_resilient,
)
