"""Engine: the fit loop every entry point drives (counterpart of
`repro.engine.engine`).

    executor = FusedExecutor(loss_fn, mcfg, opt)
    state = executor.init_state(model, seed)
    with Engine(executor, pipeline, callbacks=[LoggingCallback()]) as eng:
        report = eng.fit(state, steps=1000)

The Engine owns iteration, timing and callback dispatch. The reference's
checkpoint-restart loop (`CheckpointCallback` -> `run_resilient`), mesh
events and tracker are not ported yet (slice 3 of the port, ROADMAP.md
queue 1).
"""
from __future__ import annotations

import time
from typing import Iterable, Sequence

from repro_torch.core import TrainState
from repro_torch.engine.api import FitReport, scalar_metrics
from repro_torch.engine.callbacks import Callback


class Engine:
    def __init__(self, executor, data: Iterable[dict], callbacks: Sequence[Callback] = ()):
        self.executor = executor
        self.data = data
        self.callbacks = list(callbacks)

    def _step(self, state: TrainState, batch: dict):
        t0 = time.perf_counter()
        state, metrics = self.executor.step(state, batch)
        dt = time.perf_counter() - t0
        for cb in self.callbacks:
            cb.on_step(self, state, metrics, dt)
        return state, metrics

    def fit(self, state: TrainState, steps: int) -> FitReport:
        """Train until `state.step == steps`; returns a FitReport."""
        it = iter(self.data)
        try:
            for cb in self.callbacks:
                cb.on_fit_start(self, state)
            t0 = time.time()
            history: list = []
            while int(state.step) < steps:
                try:
                    batch = next(it)
                except StopIteration:
                    break
                state, metrics = self._step(state, batch)
                history.append(scalar_metrics(metrics))
        finally:
            if hasattr(it, "close"):
                it.close()   # stop a prefetching pipeline's worker now
        report = FitReport(final_state=state, steps_done=int(state.step), restarts=0,
                           metrics_history=history, wall_time_s=time.time() - t0)
        for cb in self.callbacks:
            cb.on_fit_end(self, report)
        return report

    def close(self) -> None:
        self.executor.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
