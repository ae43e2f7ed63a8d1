"""Chrome/Perfetto trace-event exporter, lanes as named tracks (counterpart
of `repro.obs.trace`), and the overlap report's arithmetic.

`TraceEventSink` collects the tracker's spans, events, and counter-eligible
scalars and writes Chrome trace-event JSON (the `{"traceEvents": [...]}`
object form) loadable by ui.perfetto.dev or chrome://tracing. Each lane name
("descent", "ascent-thread", "ascent-remote", "pool-worker-0")
becomes its own named track via "M" thread_name metadata, so the paper's
Fig-1 claim — the ascent (perturbation) computation hiding under descent
compute — renders as literal span overlap between the two tracks.

Timestamps arrive in `trace_now()` seconds (time.perf_counter). The trace
format wants microseconds from an arbitrary epoch; we rebase everything to
the earliest timestamp seen at close() time so traces start at t=0.

`compute_overlap` is a copy of `benchmarks/overlap_report.compute_overlap`
(the port imports nothing of the reference): the hidden-perturbation
fraction, the share of ascent-lane busy time (ascent_compute / ascent_rpc /
pool_exchange spans) that overlaps descent-lane compute (descent_compute).
"""
from __future__ import annotations

import json
import pathlib
import threading
from typing import Union

from repro_torch.obs.registry import TRACE_COUNTER_KEYS
from repro_torch.obs.tracker import Event, Sink, Span

#: The single synthetic process all tracks live under.
TRACE_PID = 1


class TraceEventSink(Sink):
    """Buffers spans/events/counters; writes the trace JSON on close()."""

    def __init__(self, path: Union[str, pathlib.Path]):
        self.path = pathlib.Path(path)
        self._lock = threading.Lock()
        self._spans: list = []      # Span
        self._events: list = []     # Event
        self._counters: list = []   # (ts, key, value)
        self._lanes: dict = {}      # lane name -> tid (stable discovery order)
        self._closed = False

    def _tid(self, lane: str) -> int:
        if lane not in self._lanes:
            self._lanes[lane] = len(self._lanes) + 1
        return self._lanes[lane]

    def log(self, metrics: dict, *, step: int) -> None:
        # counters ride the step clock: sampled when the engine logs them
        ts = None
        with self._lock:
            for key in TRACE_COUNTER_KEYS:
                if key in metrics:
                    if ts is None:
                        from repro_torch.obs.tracker import trace_now
                        ts = trace_now()
                    self._counters.append((ts, key, float(metrics[key])))

    def span(self, span: Span) -> None:
        with self._lock:
            self._tid(span.lane)
            self._spans.append(span)

    def event(self, event: Event) -> None:
        with self._lock:
            self._tid(event.lane)
            self._events.append(event)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.path.write_text(json.dumps(self._render()))

    def _render(self) -> dict:
        stamps = ([s.t0 for s in self._spans]
                  + [e.ts for e in self._events]
                  + [ts for ts, _, _ in self._counters])
        epoch = min(stamps) if stamps else 0.0

        def us(t: float) -> float:
            return round((t - epoch) * 1e6, 3)

        out = [{"name": "process_name", "ph": "M", "pid": TRACE_PID,
                "args": {"name": "repro-asyncsam"}}]
        for lane, tid in self._lanes.items():
            out.append({"name": "thread_name", "ph": "M", "pid": TRACE_PID,
                        "tid": tid, "args": {"name": lane}})
            # sort_index pins descent above ascent above pool/elastic so the
            # overlap story reads top-down
            out.append({"name": "thread_sort_index", "ph": "M",
                        "pid": TRACE_PID, "tid": tid,
                        "args": {"sort_index": tid}})
        for s in self._spans:
            out.append({"name": s.name, "ph": "X", "pid": TRACE_PID,
                        "tid": self._tid(s.lane), "ts": us(s.t0),
                        "dur": round(s.duration_s * 1e6, 3),
                        "cat": s.lane, "args": s.args})
        for e in self._events:
            out.append({"name": e.name, "ph": "i", "s": "g",
                        "pid": TRACE_PID, "tid": self._tid(e.lane),
                        "ts": us(e.ts), "cat": e.lane, "args": e.args})
        for ts, key, value in self._counters:
            out.append({"name": key, "ph": "C", "pid": TRACE_PID,
                        "ts": us(ts), "args": {key: value}})
        return {"traceEvents": out, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# the overlap report (a copy of benchmarks/overlap_report.py's arithmetic)
# ---------------------------------------------------------------------------

#: span names that are real perturbation work on a slow lane
ASCENT_BUSY = ("ascent_compute", "ascent_rpc", "pool_exchange")
#: descent-lane spans the perturbation can hide under
DESCENT_BUSY = ("descent_compute",)


def _merge(intervals: list) -> list:
    """Sorted union of (t0, t1) intervals."""
    out: list = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t1))
        else:
            out.append((t0, t1))
    return out


def _overlap(t0: float, t1: float, merged: list) -> float:
    return sum(max(0.0, min(t1, b) - max(t0, a)) for a, b in merged)


def _percentile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[int(q * (len(sorted_vals) - 1))]


def compute_overlap(trace: dict) -> dict:
    """-> the overlap report for one trace (times in seconds)."""
    spans = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    descent = _merge([(e["ts"], e["ts"] + e["dur"]) for e in spans
                      if e["name"] in DESCENT_BUSY])
    ascent = [(e["ts"], e["ts"] + e["dur"]) for e in spans
              if e["name"] in ASCENT_BUSY]
    busy_us = sum(t1 - t0 for t0, t1 in ascent)
    hidden_us = sum(_overlap(t0, t1, descent) for t0, t1 in ascent)
    steps = sorted(e["dur"] * 1e-6 for e in spans
                   if e["name"] == "train_step")
    wire = sum(e.get("args", {}).get("wire_bytes", 0) for e in spans
               if e["name"] == "ascent_rpc")
    return {
        "hidden_fraction": (hidden_us / busy_us) if busy_us else 0.0,
        "ascent_busy_s": busy_us * 1e-6,
        "hidden_s": hidden_us * 1e-6,
        "ascent_spans": len(ascent),
        "steps": len(steps),
        "step_time_p50_s": _percentile(steps, 0.50),
        "step_time_p95_s": _percentile(steps, 0.95),
        "wire_bytes_total": int(wire),
    }
