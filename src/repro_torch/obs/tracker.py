"""Tracker: one observability funnel for scalars, counters and spans
(counterpart of `repro.obs.tracker`).

Levanter's tracker idiom (a process-global "current tracker" every layer
logs through) adapted to the two-lane AsyncSAM runtime: the Engine installs
a tracker for the duration of `fit`, and every lane — the descent loop, the
in-process ascent worker thread, the remote client's socket worker, the
ascent pool's workers — reports to
`current_tracker()` without any of them holding a reference. The global is a
plain module global (NOT a contextvar): lane workers are long-lived threads
spawned before `fit` runs, and they must observe the tracker the fit
installed.

A `Tracker` fans out to composable sinks:

    MemorySink      in-memory records; strict mode rejects unregistered keys
    JsonlSink       per-step records, byte for byte the reference's
                    `StalenessTelemetry(jsonl_path=...)` records
    TraceEventSink  Chrome/Perfetto trace-event JSON with one named track
                    per lane (repro_torch.obs.trace)

Span timing uses `time.perf_counter()` everywhere (`trace_now`), so spans
recorded on different threads of one process share a clock and render with
true overlap in a trace viewer — the whole point: perturbation-hiding is
visible as ascent-lane spans literally under the descent lane's.
"""
from __future__ import annotations

import contextlib
import json
import pathlib
import threading
import time
from typing import Any, Iterator, Optional, Sequence, Union

from repro_torch.obs.registry import (ENGINE_OPTIONAL_METRIC_KEYS, validate_keys)


def trace_now() -> float:
    """The tracker clock: monotonic seconds, shared across threads."""
    return time.perf_counter()


class Span:
    """One completed timed span on a named lane (t0/t1 in trace_now time)."""

    __slots__ = ("name", "lane", "t0", "t1", "args")

    def __init__(self, name: str, lane: str, t0: float, t1: float,
                 args: Optional[dict] = None):
        self.name = name
        self.lane = lane
        self.t0 = float(t0)
        self.t1 = float(t1)
        self.args = dict(args or {})

    @property
    def duration_s(self) -> float:
        return max(0.0, self.t1 - self.t0)

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, lane={self.lane!r}, "
                f"dur={self.duration_s * 1e3:.3f}ms, args={self.args})")


class Event:
    """One instantaneous marker on a named lane."""

    __slots__ = ("name", "lane", "ts", "args")

    def __init__(self, name: str, lane: str, ts: float,
                 args: Optional[dict] = None):
        self.name = name
        self.lane = lane
        self.ts = float(ts)
        self.args = dict(args or {})


class Sink:
    """Sink interface: every hook is a no-op; implement what you need."""

    def log(self, metrics: dict, *, step: int) -> None:
        pass

    def span(self, span: Span) -> None:
        pass

    def event(self, event: Event) -> None:
        pass

    def close(self) -> None:
        pass


class MemorySink(Sink):
    """In-memory sink for tests and programmatic inspection.

    `strict=True` (the default) validates every logged metric key against
    the obs registry and raises `UnknownMetricError` on a write outside it —
    the enforcement half of the typed-key registry.
    """

    def __init__(self, strict: bool = True):
        self.strict = strict
        self._lock = threading.Lock()
        self.steps: list = []     # (step, metrics dict) in log order
        self.spans: list = []     # Span
        self.events: list = []    # Event

    def log(self, metrics: dict, *, step: int) -> None:
        if self.strict:
            validate_keys(metrics.keys())
        with self._lock:
            self.steps.append((int(step), dict(metrics)))

    def span(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)

    def event(self, event: Event) -> None:
        with self._lock:
            self.events.append(event)

    def spans_on(self, lane_prefix: str) -> list:
        """Spans whose lane starts with `lane_prefix` (e.g. "ascent")."""
        with self._lock:
            return [s for s in self.spans if s.lane.startswith(lane_prefix)]


def jsonl_record(step: int, metrics: dict) -> dict:
    """One telemetry record, in the reference's `StalenessTelemetry` shape.

    Field order is the contract: step, tau, perturbed, step_time_s, loss,
    then each ENGINE_OPTIONAL_METRIC_KEYS member present in `metrics`, in
    registry order. `StalenessTelemetry` and `JsonlSink` both build records
    here, so their output stays byte-identical.
    """
    loss = metrics.get("loss")
    rec = {"step": int(step),
           "tau": int(metrics.get("tau", 0)),
           "perturbed": float(metrics.get("perturbed", 0.0)),
           "step_time_s": metrics.get("step_time_s"),
           "loss": float(loss) if loss is not None else None}
    for key in ENGINE_OPTIONAL_METRIC_KEYS:
        if key in metrics:
            rec[key] = float(metrics[key])
    return rec


class JsonlSink(Sink):
    """Streamed per-step jsonl records (crash-safe: flushed per line).

    Byte-compatible with the records `StalenessTelemetry(jsonl_path=...)`
    wrote before the tracker existed, so `benchmarks/fig3_throughput.py` /
    `table_4_2_hetero.py` and any external consumer parse either vintage.
    """

    def __init__(self, path: Union[str, pathlib.Path]):
        self.path = pathlib.Path(path)
        self._lock = threading.Lock()
        self._fh = None

    def log(self, metrics: dict, *, step: int) -> None:
        rec = jsonl_record(step, metrics)
        with self._lock:
            if self._fh is None:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                self._fh = self.path.open("w")
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


class Tracker:
    """Fan-out facade over sinks, plus process-local counters/histograms.

    With no sinks it is the null tracker: every call is a cheap no-op, which
    is what uninstrumented runs pay.
    """

    def __init__(self, sinks: Sequence[Sink] = ()):
        self.sinks = list(sinks)
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._hists: dict = {}

    # --- scalars ------------------------------------------------------------
    def log(self, metrics: dict, *, step: int) -> None:
        """Record one step's scalar metrics in every sink."""
        for sink in self.sinks:
            sink.log(metrics, step=step)

    # --- counters / histograms ---------------------------------------------
    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def histogram(self, name: str, value: float) -> None:
        with self._lock:
            self._hists.setdefault(name, []).append(float(value))

    @property
    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def summary(self) -> dict:
        """Counters plus per-histogram {count,min,max,mean,p50,p95}."""
        with self._lock:
            hists = {}
            for name, vals in self._hists.items():
                s = sorted(vals)
                n = len(s)
                hists[name] = {
                    "count": n, "min": s[0], "max": s[-1],
                    "mean": sum(s) / n,
                    "p50": s[int(0.50 * (n - 1))],
                    "p95": s[int(0.95 * (n - 1))],
                }
            return {"counters": dict(self._counters), "histograms": hists}

    # --- spans / events -----------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, *, lane: str = "main",
             **args: Any) -> Iterator[None]:
        """`with tracker.span("ascent_exchange", lane=..., tau=...):` —
        times the body and dispatches one Span to every sink on exit (also
        on exception, so a failing step still shows its cost)."""
        t0 = trace_now()
        try:
            yield
        finally:
            self.span_at(name, lane=lane, t0=t0, t1=trace_now(), **args)

    def span_at(self, name: str, *, lane: str, t0: float, t1: float,
                **args: Any) -> None:
        """Record a span whose endpoints were measured elsewhere (e.g. the
        submit→harvest window of an asynchronous exchange)."""
        if not self.sinks:
            return
        span = Span(name, lane, t0, t1, args)
        for sink in self.sinks:
            sink.span(span)

    def event(self, name: str, *, lane: str = "main", **args: Any) -> None:
        if not self.sinks:
            return
        ev = Event(name, lane, trace_now(), args)
        for sink in self.sinks:
            sink.event(ev)

    # --- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        for sink in self.sinks:
            sink.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


#: The null tracker uninstrumented code paths see.
_NULL_TRACKER = Tracker()
_current: Tracker = _NULL_TRACKER
_current_lock = threading.Lock()


def current_tracker() -> Tracker:
    """The process-global tracker (the null tracker when none installed)."""
    return _current


def set_global_tracker(tracker: Optional[Tracker]) -> None:
    """Install `tracker` globally (None restores the null tracker)."""
    global _current
    with _current_lock:
        _current = tracker if tracker is not None else _NULL_TRACKER


@contextlib.contextmanager
def use_tracker(tracker: Tracker) -> Iterator[Tracker]:
    """Scoped install: `Engine.fit` wraps the loop in this, so lane worker
    threads observe the fit's tracker while it runs and the previous one is
    restored after (trackers don't nest across concurrent fits in one
    process — last installed wins, same as levanter's)."""
    global _current
    with _current_lock:
        prev = _current
        _current = tracker
    try:
        yield tracker
    finally:
        with _current_lock:
            _current = prev
