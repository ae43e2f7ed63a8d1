"""Engine API: one execution contract for the training schedules
(counterpart of `repro.engine.api`).

    executor.init_state(params, seed)  -> TrainState
    executor.step(state, batch)        -> (state, metrics)
    executor.close()                                      (idempotent)

plus the metric contract: every executor's step metrics include at least
`ENGINE_METRIC_KEYS` (loss, grad_norm, tau, perturbed), so callbacks and
parity tests never special-case the schedule.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

from repro_torch.core import TrainState
# the contract tuples are derived from the typed registry (obs.registry) and
# re-exported here, as the reference's engine.api does
from repro_torch.obs.registry import (ENGINE_METRIC_KEYS,  # noqa: F401
                                      ENGINE_OPTIONAL_METRIC_KEYS, scalar_metrics)


@dataclasses.dataclass
class FitReport:
    """What Engine.fit returns; the reference's fields."""
    final_state: TrainState
    steps_done: int
    restarts: int
    metrics_history: list
    wall_time_s: float
    pre_fit: Optional[dict] = None
    poison_rollbacks: int = 0


def ensure_metric_contract(metrics: dict, *, tau, perturbed) -> dict:
    """Fill contract keys an executor's raw step did not already emit."""
    metrics = dict(metrics)
    metrics.setdefault("tau", tau)
    metrics.setdefault("perturbed", perturbed)
    return metrics


def mesh_context(mesh) -> contextlib.AbstractContextManager:
    """The mesh's compute layout for the model code run inside (the
    reference's `mesh_context` with `activation_sharding`): this rank's
    `models.partitioning.Layout` on a sharded live mesh; nothing for None,
    an abstract mesh or one of 1 device."""
    from repro_torch.models.partitioning import activation_sharding
    return activation_sharding(mesh)


def cost_analysis_dict(lowered) -> dict:
    """A traced step's cost (`FusedExecutor.lower`, `utils.abstract.trace`)
    under the reference's keys: "flops", the traced flops
    (`FlopCounterMode`, the kernels' formulas included), and "bytes
    accessed", the sum over the traced ops of their tensor inputs' and
    outputs' bytes on this rank (an in-place operand as read and as
    written). The reference's comes from XLA's `cost_analysis()`, which also
    counts elementwise flops and fused ops' bytes once."""
    return {"flops": float(lowered.flops), "bytes accessed": float(lowered.bytes_accessed)}
