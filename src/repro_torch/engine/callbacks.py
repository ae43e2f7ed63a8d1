"""Engine callbacks: logging, throughput, evaluation and checkpoints
(counterpart of `repro.engine.callbacks`).

A callback observes the fit loop; it never owns it. The hooks are

    on_fit_start(engine, state)
    on_step(engine, state, metrics, step_time_s)
    on_fit_end(engine, report)

all no-ops by default. `CheckpointCallback` is the one callback the Engine
inspects: its presence routes the loop through `runtime.run_resilient`.
`StalenessTelemetry` aggregates the lane executors' tau ledger and, with
`jsonl_path`, streams one record per step through the tracker's `JsonlSink`.
"""
from __future__ import annotations

import dataclasses
import pathlib
import time
from typing import Callable, Optional, Union

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import TrainState
from repro_torch.engine.api import ENGINE_OPTIONAL_METRIC_KEYS
from repro_torch.obs import JsonlSink, scalar_metrics
from repro_torch.runtime import ResilienceConfig


class Callback:
    def on_fit_start(self, engine, state: TrainState) -> None:  # noqa: D401
        pass

    def on_step(self, engine, state: TrainState, metrics: dict,
                step_time_s: float) -> None:
        pass

    def on_fit_end(self, engine, report) -> None:
        pass


class LoggingCallback(Callback):
    """Print scalar metrics every `every` steps (and at the final step)."""

    def __init__(self, every: int = 10, total_steps: Optional[int] = None):
        self.every = max(1, every)
        self.total_steps = total_steps

    def on_step(self, engine, state, metrics, step_time_s):
        step = int(state.step)
        if step % self.every == 0 or step == self.total_steps:
            scal = {k: f"{v:.4f}" for k, v in scalar_metrics(metrics).items()}
            print(f"step {step:5d}  {scal}")


class ThroughputMeter(Callback):
    """Collect per-step wall times; summarize tokens/s (or samples/s).

    The first recorded step is dropped from the steady-state mean (it carries
    the kernels' build and first-call costs).
    """

    def __init__(self, tokens_per_batch: Optional[int] = None):
        self.tokens_per_batch = tokens_per_batch
        self.step_times: list[float] = []

    def on_step(self, engine, state, metrics, step_time_s):
        self.step_times.append(step_time_s)

    @property
    def steady_times(self) -> list[float]:
        return self.step_times[1:] or self.step_times

    def summary(self) -> dict:
        if not self.step_times:
            return {}
        steady = self.steady_times
        mean = sum(steady) / len(steady)
        out = {"mean_step_s": mean, "steps_timed": len(self.step_times)}
        if self.tokens_per_batch:
            out["tokens_per_s"] = self.tokens_per_batch / mean
        return out


class EvalCallback(Callback):
    """Run `eval_fn(state) -> float` every `every` steps (and at
    `total_steps`); keep a (t, value) curve, t the seconds since the fit
    started."""

    def __init__(self, eval_fn: Callable[[TrainState], float], every: int = 50,
                 total_steps: Optional[int] = None):
        self.eval_fn = eval_fn
        self.every = max(1, every)
        self.total_steps = total_steps
        self.curve: list[tuple[float, float]] = []
        self._t0 = None

    def on_fit_start(self, engine, state):
        self._t0 = time.perf_counter()

    def on_step(self, engine, state, metrics, step_time_s):
        step = int(state.step)
        if step % self.every == 0 or step == self.total_steps:
            self.curve.append((time.perf_counter() - (self._t0 or 0.0),
                               float(self.eval_fn(state))))


@dataclasses.dataclass
class CheckpointCallback(Callback):
    """Periodic save/restore via CheckpointManager.

    The Engine detects this callback and runs its loop under
    `run_resilient`, which owns the save cadence, the step-0 baseline
    checkpoint, and restore-and-continue on failure; `shardings` (if set,
    `runtime.elastic.state_shardings`) lets a restore re-place the state on
    the current mesh (elastic restart).
    """
    manager: CheckpointManager
    resilience: ResilienceConfig = dataclasses.field(default_factory=ResilienceConfig)
    shardings: Optional[object] = None


class StalenessTelemetry(Callback):
    """Aggregate the lane executors' tau ledger: a histogram and the count of
    steps that ran unperturbed (SGD fallbacks).

    Works against the metric contract (tau, perturbed), so it attaches to the
    fused executor too, where it records the constant tau = 1 regime.

    With `jsonl_path` set, every step also appends one JSON record
    `{step, tau, perturbed, step_time_s, loss}` plus each
    `ENGINE_OPTIONAL_METRIC_KEYS` member the step carries (the remote lane's
    wire bytes and rtt, the pool's depth and wait, the lane ladder's and the
    guard's counters), streamed through `repro_torch.obs.JsonlSink`, which
    owns the schema: the same bytes as the reference's records, so
    `benchmarks/fig3_throughput.py` and other consumers read either.
    """

    #: metric keys recorded per step when the executor emits them
    OPTIONAL_KEYS = ENGINE_OPTIONAL_METRIC_KEYS

    def __init__(self, print_summary: bool = True,
                 jsonl_path: Union[str, pathlib.Path, None] = None):
        self.print_summary = print_summary
        self.jsonl_path = pathlib.Path(jsonl_path) if jsonl_path else None
        self._sink = None
        self.tau_hist: dict[int, int] = {}
        self.sgd_fallbacks = 0
        self.perturbed_steps = 0

    def on_step(self, engine, state, metrics, step_time_s):
        tau = int(metrics.get("tau", 0))
        self.tau_hist[tau] = self.tau_hist.get(tau, 0) + 1
        if float(metrics.get("perturbed", 0.0)):
            self.perturbed_steps += 1
        else:
            self.sgd_fallbacks += 1
        if self.jsonl_path is not None:
            if self._sink is None:
                self._sink = JsonlSink(self.jsonl_path)
            self._sink.log({**metrics, "step_time_s": step_time_s}, step=int(state.step))

    def summary(self) -> dict:
        return {"tau_hist": dict(sorted(self.tau_hist.items())),
                "perturbed_steps": self.perturbed_steps,
                "sgd_fallbacks": self.sgd_fallbacks}

    def on_fit_end(self, engine, report):
        if self._sink is not None:
            self._sink.close()
            self._sink = None
        if self.print_summary:
            print(f"staleness: {self.summary()}")
