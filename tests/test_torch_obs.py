"""Port parity for observability: the typed metric registry, the tracker and
its sinks, the Chrome-trace exporter with the overlap report, and the jsonl
stream of StalenessTelemetry, each held against the reference's.

Tolerances, per check: the registry is equal field by field, key by key, in
order; `JsonlSink` and `StalenessTelemetry(jsonl_path=...)` write the same
bytes as the reference's on the same records (exact); the port's copy of
`compute_overlap` gives the reference's report on the same traces (exact);
the port's hetero lockstep trace is read by the reference's
`benchmarks/overlap_report.compute_overlap` with a hidden fraction above 0.
"""
import ast
import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.engine.callbacks import StalenessTelemetry as JStalenessTelemetry
from repro.obs import registry as jregistry
from repro.obs import JsonlSink as JJsonlSink
from repro.obs import Tracker as JTracker
from repro_torch import optim
from repro_torch.core import MethodConfig, slice_ascent_batch
from repro_torch.data.synthetic import ClassificationTask
from repro_torch.engine import (ENGINE_METRIC_KEYS, ENGINE_OPTIONAL_METRIC_KEYS, Engine,
                                FusedExecutor, HeteroExecutor, RemoteExecutor,
                                StalenessTelemetry)
from repro_torch.obs import (METRIC_KEYS, REGISTRY, TRACE_COUNTER_KEYS, JsonlSink, MemorySink,
                             TraceEventSink, Tracker, UnknownMetricError, compute_overlap,
                             current_tracker, metric_key, registry_table, scalar_metrics,
                             use_tracker, validate_keys)
from repro_torch.obs import registry
from repro_torch.runtime import ExecutorConfig
from repro_torch.service.ascent_server import AscentServer
from repro_torch.service.testing import mlp_init, mlp_loss

ROOT = pathlib.Path(__file__).resolve().parent.parent
TASK = ClassificationTask(n_classes=4, dim=8, seed=3)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """A few intra-op threads: the suite runs files side by side in several
    workers, and the JAX tests beside these time their own threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _overlap_mod():
    """benchmarks/ is not a package: import overlap_report from its path."""
    spec = importlib.util.spec_from_file_location(
        "overlap_report", ROOT / "benchmarks" / "overlap_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _batches(n, batch=64, frac=0.5):
    return [{**b, "ascent": slice_ascent_batch(b, frac)}
            for b in TASK.train_batches(batch, n, device="cpu")]


def _mcfg():
    return MethodConfig(name="async_sam", rho=0.05, ascent_fraction=0.5)


def _params():
    return mlp_init(0, (8, 32, 4), device="cpu")


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_equals_reference_field_by_field():
    assert len(METRIC_KEYS) == len(jregistry.METRIC_KEYS)
    for k, jk in zip(METRIC_KEYS, jregistry.METRIC_KEYS):
        assert dataclasses.astuple(k) == dataclasses.astuple(jk)
        assert [f.name for f in dataclasses.fields(k)] == \
            [f.name for f in dataclasses.fields(jk)]
    assert list(REGISTRY) == list(jregistry.REGISTRY)
    assert ENGINE_METRIC_KEYS == jregistry.ENGINE_METRIC_KEYS == (
        "loss", "grad_norm", "tau", "perturbed")
    assert ENGINE_OPTIONAL_METRIC_KEYS == jregistry.ENGINE_OPTIONAL_METRIC_KEYS
    assert TRACE_COUNTER_KEYS == jregistry.TRACE_COUNTER_KEYS
    assert registry_table() == jregistry.registry_table()
    from repro_torch.core.api import scalar_metrics as core_scalar_metrics
    assert core_scalar_metrics is scalar_metrics      # core/api re-exports it


def test_registry_lookup_and_validation():
    assert metric_key("tau").required and metric_key("tau").source == "lane"
    with pytest.raises(UnknownMetricError):
        metric_key("nonesuch")
    validate_keys(["loss", "tau", "step_time_s"])
    with pytest.raises(UnknownMetricError, match="bogus"):
        validate_keys(["loss", "bogus"])


def test_strict_memory_sink_rejects_unregistered_key():
    strict = MemorySink(strict=True)
    strict.log({"loss": 1.0, "tau": 1}, step=0)
    with pytest.raises(UnknownMetricError):
        strict.log({"loss": 1.0, "made_up_key": 2.0}, step=1)
    assert len(strict.steps) == 1
    relaxed = MemorySink(strict=False)
    relaxed.log({"made_up_key": 2.0}, step=0)
    assert relaxed.steps == [(0, {"made_up_key": 2.0})]


def _metric_writes(path: pathlib.Path) -> list:
    """[(lineno, key)] for each static metric write in a file: a subscript
    assignment, setdefault, update or dict-literal rebind on any name ending
    in "metrics" (dynamic keys are the strict sink's to check)."""
    def name(node):
        return isinstance(node, ast.Name) and node.id.endswith("metrics")

    def const(node):
        return node.value if isinstance(node, ast.Constant) and isinstance(node.value,
                                                                           str) else None

    found = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        keys = []
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript) and name(tgt.value):
                    keys.append(const(tgt.slice))
                if name(tgt) and isinstance(node.value, ast.Dict):
                    keys += [const(k) for k in node.value.keys]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr in ("setdefault", "update") and name(node.func.value)):
            if node.func.attr == "setdefault" and node.args:
                keys.append(const(node.args[0]))
            else:
                for arg in node.args:
                    if isinstance(arg, ast.Dict):
                        keys += [const(k) for k in arg.keys]
        found += [(node.lineno, k) for k in keys if k is not None]
    return found


def test_every_static_metric_write_in_the_port_is_registered():
    writes, bad = 0, []
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        for lineno, key in _metric_writes(path):
            writes += 1
            if key not in REGISTRY:
                bad.append(f"{path.relative_to(ROOT)}:{lineno}: {key!r}")
    assert not bad, bad
    assert writes >= 20       # the scan sees the port's writes


# ---------------------------------------------------------------------------
# the tracker
# ---------------------------------------------------------------------------

def test_use_tracker_scoped_install_and_null_default():
    base = current_tracker()
    assert base.log({"loss": 1.0}, step=0) is None
    trk = Tracker([MemorySink()])
    with use_tracker(trk) as active:
        assert current_tracker() is trk is active
    assert current_tracker() is base


def test_tracker_summary_matches_reference():
    out = []
    for cls in (Tracker, JTracker):
        trk = cls()
        for _ in range(3):
            trk.count("harvests")
        for v in (1.0, 2.0, 3.0, 4.0, 0.5, 9.0):
            trk.histogram("step_time_s", v)
        out.append(trk.summary())
    assert out[0] == out[1]
    assert out[0]["histograms"]["step_time_s"]["p95"] == 4.0


def test_span_records_lane_args_and_survives_exceptions():
    sink = MemorySink()
    trk = Tracker([sink])
    with trk.span("descent_compute", lane="descent", step=7):
        pass
    with pytest.raises(RuntimeError):
        with trk.span("ascent_compute", lane="ascent-thread", gen=3):
            raise RuntimeError("boom")
    trk.span_at("ascent_exchange", lane="ascent-thread", t0=1.0, t1=1.5, tau=1)
    assert [s.name for s in sink.spans] == ["descent_compute", "ascent_compute",
                                            "ascent_exchange"]
    assert sink.spans_on("ascent")[0].args == {"gen": 3}
    assert sink.spans[2].duration_s == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# jsonl: the reference's bytes
# ---------------------------------------------------------------------------

_ROWS = [
    (0, {"loss": 0.5, "tau": 0, "perturbed": 0.0, "grad_norm": 1.0}, 0.0123),
    (1, {"loss": 0.4, "tau": 1, "perturbed": 1.0, "grad_norm": 0.9, "wire_bytes": 4096.0,
         "job_bytes": 3072.0, "grad_bytes": 1024.0, "rtt_s": 0.002}, 0.011),
    (2, {"tau": 2, "perturbed": 1.0, "pool_depth": 3.0, "pool_wait_s": 0.001,
         "client_id": 7.0, "lane_state": 1.0, "lane_failovers": 1.0}, 0.0105),
    (3, {"loss": 0.31234567, "tau": 1, "perturbed": 1.0, "guard_state": 1.0,
         "rho_scale": 0.5, "steps_skipped": 2.0, "nonfinite_count": 32.0,
         "update_skipped": 1.0}, 0.0101),
]


def _as_torch(m: dict) -> dict:
    """The port's metrics as a step emits them: float scalars as 0-d fp32
    tensors, tau a host int."""
    return {k: (v if k == "tau" else torch.tensor(v, dtype=torch.float32))
            for k, v in m.items()}


def test_jsonl_sink_writes_the_reference_bytes(tmp_path):
    for cls, name, conv in ((JsonlSink, "port", _as_torch), (JJsonlSink, "ref", dict)):
        sink = cls(tmp_path / f"{name}.jsonl")
        for step, m, dt in _ROWS:
            sink.log({**conv(m), "step_time_s": dt}, step=step)
        sink.close()
    # the port's tensors carry fp32 values; the reference's sink on the same
    # fp32 values must give the same bytes
    sink = JJsonlSink(tmp_path / "ref32.jsonl")
    for step, m, dt in _ROWS:
        sink.log({**{k: (v if k == "tau" else float(np.float32(v))) for k, v in m.items()},
                  "step_time_s": dt}, step=step)
    sink.close()
    got = (tmp_path / "port.jsonl").read_bytes()
    assert got == (tmp_path / "ref32.jsonl").read_bytes()
    assert len(got.splitlines()) == 4
    # with the same (host float) records, the two packages' sinks are one
    sink = JsonlSink(tmp_path / "port64.jsonl")
    for step, m, dt in _ROWS:
        sink.log({**m, "step_time_s": dt}, step=step)
    sink.close()
    assert (tmp_path / "port64.jsonl").read_bytes() == (tmp_path / "ref.jsonl").read_bytes()


def test_staleness_telemetry_writes_the_reference_bytes(tmp_path):
    class _S:
        def __init__(self, step):
            self.step = step

    for cls, name in ((StalenessTelemetry, "port"), (JStalenessTelemetry, "ref")):
        tel = cls(print_summary=False, jsonl_path=tmp_path / f"{name}.jsonl")
        for step, m, dt in _ROWS:
            tel.on_step(None, _S(step + 1), dict(m), dt)
        tel.on_fit_end(None, None)
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "ref.jsonl").read_bytes()


def test_staleness_telemetry_streams_a_fit(tmp_path):
    path = tmp_path / "tau.jsonl"
    tel = StalenessTelemetry(print_summary=False, jsonl_path=path)
    with FusedExecutor(mlp_loss, _mcfg(), optim.sgd(0.1, momentum=0.9)) as ex:
        state = ex.init_state(_params(), 1)
        Engine(ex, _batches(4), [tel]).fit(state, 4)
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(recs) == 4
    assert list(recs[0])[:5] == ["step", "tau", "perturbed", "step_time_s", "loss"]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]


# ---------------------------------------------------------------------------
# every executor logs registered keys through the engine's tracker route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["fused", "hetero", "hetero_ladder"])
def test_executors_emit_registered_keys_every_step(kind):
    opt = optim.sgd(0.1, momentum=0.9)
    if kind == "fused":
        ex = FusedExecutor(mlp_loss, _mcfg(), opt)
    else:
        ex = HeteroExecutor(mlp_loss, _mcfg(), opt, exec_cfg=ExecutorConfig(
            lockstep=True, lane_ladder=kind == "hetero_ladder"))
    sink = MemorySink(strict=True)
    with ex:
        state = ex.init_state(_params(), 1)
        Engine(ex, _batches(6)).fit(state, 6, tracker=Tracker([sink]))
    assert len(sink.steps) == 6
    for _, metrics in sink.steps:
        assert set(ENGINE_METRIC_KEYS) <= set(metrics) and "step_time_s" in metrics
        if kind == "hetero_ladder":
            assert metrics["lane_state"] == 0.0
    lanes = {s.lane for s in sink.spans}
    assert "descent" in lanes
    if kind != "fused":
        assert "ascent-thread" in lanes


def test_remote_executor_registered_keys_and_rpc_spans():
    server = AscentServer(mlp_loss, device="cpu")
    server.serve_in_thread()
    try:
        sink = MemorySink(strict=True)
        xcfg = ExecutorConfig(lockstep=True, ascent_addr=server.address, lane_ladder=True)
        with RemoteExecutor(mlp_loss, _mcfg(), optim.sgd(0.1, momentum=0.9),
                            exec_cfg=xcfg) as ex:
            state = ex.init_state(_params(), 1)
            Engine(ex, _batches(6)).fit(state, 6, tracker=Tracker([sink]))
            # the pool's workers report to the fit's tracker too (one process)
    finally:
        server.close()
    for _, metrics in sink.steps:
        assert set(ENGINE_METRIC_KEYS) <= set(metrics)
        assert metrics["lane_state"] == 0.0
    assert any("wire_bytes" in m for _, m in sink.steps)
    rpc = [s for s in sink.spans if s.name == "ascent_rpc"]
    assert len(rpc) >= 5 and all(s.args["wire_bytes"] > 0 for s in rpc)
    assert all(s.lane == "ascent-remote" for s in rpc)
    assert [s for s in sink.spans if s.name == "pool_exchange"]


# ---------------------------------------------------------------------------
# the trace exporter and the overlap report
# ---------------------------------------------------------------------------

def test_hetero_lockstep_trace_is_read_by_the_reference_overlap_report(tmp_path):
    trace_path = tmp_path / "overlap.json"
    sink = TraceEventSink(trace_path)
    with HeteroExecutor(mlp_loss, _mcfg(), optim.sgd(0.1, momentum=0.9),
                        exec_cfg=ExecutorConfig(lockstep=True)) as ex:
        state = ex.init_state(_params(), 1)
        with Tracker([sink]) as trk:
            Engine(ex, _batches(12)).fit(state, 12, tracker=trk)
    trace = json.loads(trace_path.read_text())
    evs = trace["traceEvents"]
    lanes = {e["args"]["name"] for e in evs if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"descent", "ascent-thread"} <= lanes
    spans = [e for e in evs if e["ph"] == "X"]
    assert spans and all(e["ts"] >= 0 and e["dur"] >= 0 for e in spans)
    assert {e["name"] for e in spans} >= {"train_step", "descent_compute", "ascent_compute",
                                          "ascent_exchange"}
    assert {"loss", "tau"} <= {e["name"] for e in evs if e["ph"] == "C"}
    report = _overlap_mod().compute_overlap(trace)
    assert report["steps"] == 12 and report["ascent_busy_s"] > 0
    assert report["hidden_fraction"] > 0
    assert report["step_time_p95_s"] >= report["step_time_p50_s"] > 0
    assert compute_overlap(trace) == report          # the port's copy


def test_overlap_copy_matches_reference_on_synthetic_traces():
    mod = _overlap_mod()
    mk = lambda name, ts, dur, **a: {"name": name, "ph": "X", "ts": ts,  # noqa: E731
                                     "dur": dur, "cat": "x", "pid": 1, "tid": 1, "args": a}
    trace = {"traceEvents": [
        mk("descent_compute", 0, 100), mk("descent_compute", 200, 100),
        mk("ascent_compute", 50, 100), mk("ascent_compute", 400, 50),
        mk("ascent_rpc", 250, 30, wire_bytes=77), mk("pool_exchange", 90, 20),
        mk("train_step", 0, 120), mk("train_step", 200, 110)]}
    assert compute_overlap(trace) == mod.compute_overlap(trace)
    assert compute_overlap(trace)["wire_bytes_total"] == 77
    assert compute_overlap({"traceEvents": []}) == mod.compute_overlap({"traceEvents": []})


def test_scalar_metrics_filters_to_floatable():
    out = scalar_metrics({"loss": torch.tensor(0.5), "tau": 1, "logits": torch.zeros(4, 4),
                          "note": "skip"})
    assert out == {"loss": 0.5, "tau": 1.0}
    assert REGISTRY["loss"].trace_counter and registry.REGISTRY is REGISTRY
