"""repro_torch.runtime: checkpoint-restart (counterpart of the
`fault_tolerance` part of `repro.runtime`). The reference's heterogeneous
executor, guard, health, chaos and elastic modules are later slices
(ROADMAP.md queue 1)."""
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    InjectedFailure,
    PoisonBatch,
    ResilienceConfig,
    RestartBudget,
    RunReport,
    run_resilient,
)
