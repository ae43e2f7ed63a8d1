"""repro_torch.runtime: checkpoint-restart, the heterogeneous asynchronous
executor, the numerics guard, lane health with the degradation ladder and the
server watchdog, the scripted chaos schedule and elastic resharding between
meshes (counterpart of `repro.runtime`)."""
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
from repro_torch.runtime.elastic import (  # noqa: F401
    LeafSharding,
    make_sized_mesh,
    reshard_state,
    state_shardings,
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
