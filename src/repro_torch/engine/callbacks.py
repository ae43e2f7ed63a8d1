"""Engine callbacks: logging, throughput and checkpoints (counterpart of
`repro.engine.callbacks`).

A callback observes the fit loop; it never owns it. The hooks are

    on_fit_start(engine, state)
    on_step(engine, state, metrics, step_time_s)
    on_fit_end(engine, report)

all no-ops by default. `CheckpointCallback` is the one callback the Engine
inspects: its presence routes the loop through `runtime.run_resilient`.
`StalenessTelemetry` aggregates the lane executors' tau ledger. The
reference's eval callback and the staleness callback's jsonl stream (its
sink is the tracker's) come with later slices (ROADMAP.md queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import TrainState
from repro_torch.engine.api import scalar_metrics
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


@dataclasses.dataclass
class CheckpointCallback(Callback):
    """Periodic save/restore via CheckpointManager.

    The Engine detects this callback and runs its loop under
    `run_resilient`, which owns the save cadence, the step-0 baseline
    checkpoint, and restore-and-continue on failure.
    """
    manager: CheckpointManager
    resilience: ResilienceConfig = dataclasses.field(default_factory=ResilienceConfig)


class StalenessTelemetry(Callback):
    """Aggregate the lane executors' tau ledger: a histogram and the count of
    steps that ran unperturbed (SGD fallbacks).

    Works against the metric contract (tau, perturbed), so it attaches to the
    fused executor too, where it records the constant tau = 1 regime. The
    reference's `jsonl_path` stream is the tracker slice's (ROADMAP.md
    queue 1).
    """

    def __init__(self, print_summary: bool = True):
        self.print_summary = print_summary
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

    def summary(self) -> dict:
        return {"tau_hist": dict(sorted(self.tau_hist.items())),
                "perturbed_steps": self.perturbed_steps,
                "sgd_fallbacks": self.sgd_fallbacks}

    def on_fit_end(self, engine, report):
        if self.print_summary:
            print(f"staleness: {self.summary()}")
