"""repro_torch.obs: observability, the metric registry, the tracker and its
sinks (counterpart of `repro.obs`).

    tracker = Tracker([JsonlSink("run.jsonl"), TraceEventSink("trace.json")])
    Engine(...).fit(state, batches, tracker=tracker)

and every layer below (executors, ascent lanes, the remote client, the
ascent pool's workers) reports spans and metrics through `current_tracker()`
for the duration of the fit. `compute_overlap` reads a trace's
hidden-perturbation fraction (a copy of `benchmarks/overlap_report.py`'s).
"""
from repro_torch.obs.registry import (ENGINE_METRIC_KEYS,
                                ENGINE_OPTIONAL_METRIC_KEYS, METRIC_KEYS,
                                REGISTRY, TRACE_COUNTER_KEYS, MetricKey,
                                UnknownMetricError, metric_key,
                                registry_table, scalar_metrics,
                                validate_keys)
from repro_torch.obs.tracker import (Event, JsonlSink, MemorySink, Sink, Span,
                               Tracker, current_tracker, jsonl_record,
                               set_global_tracker, trace_now, use_tracker)
from repro_torch.obs.trace import TraceEventSink, compute_overlap

__all__ = [
    "ENGINE_METRIC_KEYS", "ENGINE_OPTIONAL_METRIC_KEYS", "METRIC_KEYS",
    "REGISTRY", "TRACE_COUNTER_KEYS", "MetricKey", "UnknownMetricError",
    "metric_key", "registry_table", "scalar_metrics", "validate_keys",
    "Event", "JsonlSink", "MemorySink", "Sink", "Span", "Tracker",
    "current_tracker", "jsonl_record", "set_global_tracker", "trace_now",
    "use_tracker", "TraceEventSink", "compute_overlap",
]
