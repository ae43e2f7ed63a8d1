"""repro_torch.runtime: checkpoint-restart, the heterogeneous asynchronous
executor, the numerics guard, lane health with the degradation ladder and the
server watchdog, and the scripted chaos schedule (counterpart of
`repro.runtime`). The reference's elastic module is the distributed slice
(ROADMAP.md queue 1)."""
from repro_torch.runtime.async_executor import (  # noqa: F401
    AsyncSamExecutor,
    ExecutorConfig,
    LedgerOnlyLane,
    ThreadAscentLane,
    ascent_exchange,
)
from repro_torch.runtime.chaos import (  # noqa: F401
    ChaosSchedule,
    DeviceLoss,
    MeshEvent,
    parse_schedule,
)
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    InjectedFailure,
    PoisonBatch,
    ResilienceConfig,
    RestartBudget,
    RunReport,
    run_resilient,
)
from repro_torch.runtime.guard import (  # noqa: F401
    GuardConfig,
    GuardedExecutor,
    NumericChaos,
    NumericChaosPipeline,
    NumericRule,
    SpikeDetector,
    parse_numchaos,
)
from repro_torch.runtime.health import (  # noqa: F401
    LADDER_LEVELS,
    LaneHealth,
    LaneLadder,
    ServerWatchdog,
)
