"""Engine callbacks: logging and throughput (counterpart of
`repro.engine.callbacks`).

A callback observes the fit loop; it never owns it. The hooks are

    on_fit_start(engine, state)
    on_step(engine, state, metrics, step_time_s)
    on_fit_end(engine, report)

all no-ops by default. The reference's eval, checkpoint and staleness
callbacks come with slice 3 and Form B (ROADMAP.md queue 1).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import TrainState
from repro_torch.engine.api import scalar_metrics


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
