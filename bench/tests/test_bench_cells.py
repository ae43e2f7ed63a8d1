"""One small run of each cell's traffic on the CPU (reduced presets, the
kernels' plain versions), through the harness's kinds, ending in a result
line of the contract's shape."""
from __future__ import annotations

import json
import math
import subprocess
import sys

import pytest

from bench import harness

BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


class _Device:
    """The result's device block as a CPU run fills it (no card here)."""
    @staticmethod
    def info(peak: int) -> dict:
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_and_checks_on_the_cpu(workload, small_ctx):
    ctx = small_ctx(workload)
    out = harness.kind_module(ctx.traffic).run(ctx)
    line = harness.result(BENCH, workload, out, _Device.info(out.memory_peak_bytes),
                          traced=False)
    line = json.loads(json.dumps(line))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in harness.cell_metrics(BENCH, workload, traced=False)}
    assert set(line["metrics"]) == want and "setup_s" in want
    for m in line["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0 and m["unit"]
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_every_cell_reports_an_end_to_end_and_a_per_layer_metric():
    for w in CELLS:
        e2e = {m["name"] for m in harness.cell_metrics(BENCH, w, traced=False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.cell_metrics(BENCH, w, traced=True)
        assert layer and all(m["moves"] in e2e for m in layer)


def test_every_metric_has_its_reader_and_every_cell_its_files():
    for m in BENCH["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    for w in CELLS:
        cell, cfg, traffic, limits = harness.cell_files(w, BENCH)
        assert harness.kind_module(traffic).run
        assert limits and all(v > 0 for v in limits.values())


def test_run_without_a_card_exits_without_a_result():
    proc = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload", CELLS[0],
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=120, cwd=harness.ROOT)
    if "needs 1 CUDA card" not in proc.stderr:
        pytest.skip("this machine has a CUDA card")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
