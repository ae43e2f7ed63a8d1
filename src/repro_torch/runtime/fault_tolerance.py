"""Fault-tolerant training loop: checkpoint-restart with failure injection
(counterpart of `repro.runtime.fault_tolerance`).

`run_resilient` wraps a step function with the production loop: periodic
checkpoints (model state + data-pipeline cursor), restore-and-continue on a
failed step, a bounded restart budget, and a pluggable failure injector.
The step functions write their state in place, so a restore copies the
checkpoint INTO the live state's tensors (`buckets.residentize(...,
like=state)`): the model's parameters and the step's gradient views keep
pointing at the same buffers. Every step derives its generators from
(rng, step) and the pipeline replays from its cursor, so a restarted run
gives the same bits as an uninterrupted one.

`PoisonBatch` is the reference's class; the numerics guard
(`runtime.guard`) raises it at its bottom rung, and the loop then restores
the checkpoint but keeps the pipeline cursor.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import TrainState
from repro_torch.core.api import scalar_metrics
from repro_torch.utils import buckets

log = logging.getLogger("repro_torch.fault_tolerance")


class InjectedFailure(RuntimeError):
    """Raised by failure injectors (stands in for a lost node / preemption)."""


class PoisonBatch(RuntimeError):
    """A NaN-class training-dynamics failure pinned to the data, not a node.

    `run_resilient` rolls the model state back to the last checkpoint but
    keeps the pipeline cursor, so the restarted run trains on fresh data
    instead of replaying the poison window.
    """


@dataclasses.dataclass
class ResilienceConfig:
    save_every: int = 50
    #: restarts tolerated; counted over the whole run when
    #: `restart_window_s` is None, else within that rolling window
    max_restarts: int = 5
    async_save: bool = True
    restart_window_s: Optional[float] = None
    #: refuse rollback targets whose float leaves are non-finite (restore
    #: falls back to the newest finite older step)
    require_finite_restore: bool = False


class RestartBudget:
    """Bounded restart accounting: lifetime or rolling-window.

    `spend()` records one event and raises RuntimeError once more than
    `limit` events land inside `window_s` seconds (every event ever, when
    `window_s` is None). `clock` is injectable for deterministic tests.
    """

    def __init__(self, limit: int, window_s: Optional[float] = None, *,
                 what: str = "restart", clock: Callable[[], float] = time.monotonic):
        self.limit = limit
        self.window_s = window_s
        self.what = what
        self.clock = clock
        self.total = 0
        self._times: list[float] = []

    def in_window(self) -> int:
        if self.window_s is not None:
            now = self.clock()
            self._times = [t for t in self._times if now - t <= self.window_s]
        return len(self._times)

    def spend(self, cause: Optional[BaseException] = None) -> int:
        self.total += 1
        self._times.append(self.clock())
        used = self.in_window()
        if used > self.limit:
            scope = (f"within {self.window_s:g}s window" if self.window_s is not None
                     else "lifetime")
            raise RuntimeError(f"exceeded {self.what} budget ({self.limit} {scope})"
                               ) from cause
        return used


@dataclasses.dataclass
class RunReport:
    final_state: TrainState
    steps_done: int
    restarts: int
    metrics_history: list
    wall_time_s: float
    #: restarts classified as PoisonBatch (data advanced past the window)
    poison_rollbacks: int = 0


def run_resilient(step_fn: Callable[[TrainState, dict], tuple[TrainState, dict]],
                  state: TrainState,
                  pipeline,
                  manager: CheckpointManager,
                  n_steps: int,
                  rcfg: Optional[ResilienceConfig] = None,
                  failure_injector: Optional[Callable[[int], None]] = None,
                  on_restore: Optional[Callable[[TrainState], Optional[TrainState]]] = None,
                  shardings=None) -> RunReport:
    """Run `n_steps` of `step_fn`, surviving crashes via checkpoint-restart.

    The reference's cadence: a blocking baseline checkpoint at the first
    step, then one after every step with `step % save_every == 0` and after
    the last (asynchronous with `rcfg.async_save`). `failure_injector(step)`
    may raise to simulate a node loss; a failed asynchronous save surfaces
    the same way, from the next `save()`. Either costs one restart and a
    rollback to the newest checkpoint that verifies. The pipeline exposes
    state()/restore() (`repro_torch.data.pipeline`). `on_restore` is called
    with the restored state after every rollback; a state it returns
    replaces the restored one. `shardings` (`runtime.elastic.
    state_shardings`) places a restored sharded state on that mesh; without
    it each leaf is placed as the live state's is.

    On disk a checkpoint is the state's portable, per-leaf form (the
    reference's format, `checkpoint.manager`), with the bucket layout stamped
    in its extras when the state is resident.
    """
    rcfg = rcfg or ResilienceConfig()
    t_start = time.time()
    budget = RestartBudget(rcfg.max_restarts, rcfg.restart_window_s)
    history: list = []
    poison_rollbacks = 0
    resident = buckets.is_resident(state)

    def snapshot_extras() -> dict:
        extras = {"pipeline": pipeline.state()}
        if resident:
            extras["bucket_layout"] = buckets.layout_stamp(state)
        return extras

    # step-0 baseline, so the first restart always has a target
    manager.save(int(state.step), state, extras=snapshot_extras(), blocking=True)

    while True:
        it = iter(pipeline)
        try:
            step = int(state.step)
            while step < n_steps:
                try:
                    batch = next(it)
                except StopIteration:
                    break   # finite data exhausted: a clean partial run
                if failure_injector is not None:
                    failure_injector(step)
                state, metrics = step_fn(state, batch)
                step = int(state.step)
                history.append(scalar_metrics(metrics))
                if step % rcfg.save_every == 0 or step == n_steps:
                    manager.save(step, state, extras=snapshot_extras(),
                                 blocking=not rcfg.async_save)
            manager.wait()
            return RunReport(final_state=state, steps_done=step, restarts=budget.total,
                             metrics_history=history, wall_time_s=time.time() - t_start,
                             poison_rollbacks=poison_rollbacks)
        except Exception as e:  # noqa: BLE001 (the loop is the failure domain)
            poison = isinstance(e, PoisonBatch)
            used = budget.spend(cause=e)   # raises past the (windowed) budget
            log.warning("step failed (%s: %s); restart %d/%d in window (%d total)",
                        type(e).__name__, e, used, rcfg.max_restarts, budget.total)
            manager.wait()
            restored, extras = manager.restore(state, device="cpu",
                                               require_finite=rcfg.require_finite_restore,
                                               shardings=shardings)
            state = buckets.residentize(restored, like=state)
            if poison:
                # the model rolls back, the data does not: the live cursor
                # already sits past the poison window
                poison_rollbacks += 1
                log.warning("poison-batch rollback: model restored, pipeline cursor kept "
                            "at %s", pipeline.state())
            else:
                pipeline.restore(extras["pipeline"])
            if on_restore is not None:
                adopted = on_restore(state)
                if adopted is not None:
                    state = adopted
        finally:
            if hasattr(it, "close"):
                it.close()   # stop a prefetching pipeline's worker now
