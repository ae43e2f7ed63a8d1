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

import dataclasses
from typing import Optional

from repro_torch.core import TrainState

# the reference's contract keys (repro.obs.registry), same names, same order
ENGINE_METRIC_KEYS = ("loss", "grad_norm", "tau", "perturbed")


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


def scalar_metrics(metrics: dict) -> dict:
    """The float()-able subset of a step's metrics, as host floats (a copy of
    `repro.obs.scalar_metrics`); reading a device scalar waits for it."""
    return {k: float(v) for k, v in metrics.items()
            if hasattr(v, "__float__") and getattr(v, "ndim", 0) == 0}
