"""Engine: the fit loop every entry point drives (counterpart of
`repro.engine.engine`).

    executor = FusedExecutor(loss_fn, mcfg, opt)
    state = executor.init_state(model, seed)
    with Engine(executor, pipeline, callbacks=[LoggingCallback()]) as eng:
        report = eng.fit(state, steps=1000)

The Engine owns iteration, timing and callback dispatch. An executor with a
`pre_fit(state, batch)` hook (the lane executors' system-aware calibration)
gets it called once before the loop, on a probe batch, and its report lands
in `FitReport.pre_fit`. With a `CheckpointCallback` the loop runs under
`runtime.run_resilient` (checkpoints, restore-and-continue on a failed step).
`fit(tracker=...)` installs a `repro_torch.obs.Tracker` for the fit: each
step runs under a `train_step` span (host time: on the card it ends when the
executor's step returns, after whatever synchronize the executor does) and
logs its scalars and `step_time_s` to the tracker. The reference's mesh
events (`events=`, its elastic executor) are the distributed slice
(ROADMAP.md queue 1); a `runtime.chaos.ChaosSchedule` passed as
`failure_injector` raises its crash events as it does in the reference.
"""
from __future__ import annotations

import time
from typing import Iterable, Optional, Sequence

from repro_torch.core import TrainState
from repro_torch.engine.api import FitReport
from repro_torch.engine.callbacks import Callback, CheckpointCallback
from repro_torch.obs import Tracker, current_tracker, scalar_metrics, use_tracker
from repro_torch.runtime import run_resilient


class Engine:
    def __init__(self, executor, data: Iterable[dict], callbacks: Sequence[Callback] = ()):
        self.executor = executor
        self.data = data
        self.callbacks = list(callbacks)
        self.pre_fit_report: Optional[dict] = None

    def _probe_batch(self) -> dict:
        """A batch for calibration probes, without advancing the cursor when
        the pipeline supports peek()."""
        peek = getattr(self.data, "peek", None)
        if peek is not None:
            return peek()
        it = iter(self.data)
        try:
            return next(it)
        finally:
            if hasattr(it, "close"):
                it.close()

    def _step(self, state: TrainState, batch: dict):
        trk = current_tracker()
        t0 = time.perf_counter()
        with trk.span("train_step", lane="descent", step=int(state.step)):
            state, metrics = self.executor.step(state, batch)
        dt = time.perf_counter() - t0
        if trk.sinks:
            trk.log({**scalar_metrics(metrics), "step_time_s": dt}, step=int(state.step))
        trk.histogram("step_time_s", dt)
        for cb in self.callbacks:
            cb.on_step(self, state, metrics, dt)
        return state, metrics

    def fit(self, state: TrainState, steps: int, *, warmup: int = 0,
            failure_injector=None, tracker: Optional[Tracker] = None) -> FitReport:
        """Train until `state.step == steps`; returns a FitReport.

        warmup: steps executed before the clock starts and before
        `on_fit_start` fires. failure_injector(step) may raise to simulate a
        lost node; it is the resilient loop's, so it acts with a
        CheckpointCallback only (as in the reference).

        tracker: installed as the process-global current tracker for the
        fit (`obs.use_tracker`), so the lanes report spans to it from their
        own threads. Without one, whatever tracker is current (by default the
        null tracker) stays in effect.
        """
        if tracker is not None:
            with use_tracker(tracker):
                return self._fit(state, steps, warmup=warmup,
                                 failure_injector=failure_injector)
        return self._fit(state, steps, warmup=warmup, failure_injector=failure_injector)

    def _fit(self, state: TrainState, steps: int, *, warmup: int,
             failure_injector) -> FitReport:
        hook = getattr(self.executor, "pre_fit", None)
        if hook is not None and getattr(self.executor, "wants_pre_fit", True):
            self.pre_fit_report = hook(state, self._probe_batch())
        ckpt: Optional[CheckpointCallback] = next(
            (c for c in self.callbacks if isinstance(c, CheckpointCallback)), None)
        if warmup and ckpt is not None:
            # run_resilient re-iterates the pipeline from its cursor; a
            # separate warmup iterator would replay or orphan its worker
            raise ValueError("warmup is not supported with CheckpointCallback")
        it = iter(self.data) if ckpt is None else None
        try:
            for _ in range(warmup):
                state, _ = self.executor.step(state, next(it))
            for cb in self.callbacks:
                cb.on_fit_start(self, state)
            if ckpt is not None:
                rep = run_resilient(self._step, state, self.data, ckpt.manager, steps,
                                    ckpt.resilience, failure_injector,
                                    on_restore=getattr(self.executor, "on_restore", None))
                report = FitReport(final_state=rep.final_state, steps_done=rep.steps_done,
                                   restarts=rep.restarts, metrics_history=rep.metrics_history,
                                   wall_time_s=rep.wall_time_s,
                                   poison_rollbacks=rep.poison_rollbacks)
            else:
                t0 = time.time()
                history: list = []
                while int(state.step) < steps:
                    try:
                        batch = next(it)
                    except StopIteration:
                        break
                    state, metrics = self._step(state, batch)
                    history.append(scalar_metrics(metrics))
                report = FitReport(final_state=state, steps_done=int(state.step), restarts=0,
                                   metrics_history=history, wall_time_s=time.time() - t0)
        finally:
            if it is not None and hasattr(it, "close"):
                it.close()   # stop a prefetching pipeline's worker now
        report.pre_fit = self.pre_fit_report
        for cb in self.callbacks:
            cb.on_fit_end(self, report)
        return report

    def close(self) -> None:
        self.executor.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
