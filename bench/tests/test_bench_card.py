"""Each cell run as the benchmark runs it, on the card: a short window, a
result line that is correct. Skips without a CUDA card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from bench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload, card):
    proc = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload", workload,
                           "--seed", str(2**31 + 101), "--seconds", "8", "--trace", "0"],
                          capture_output=True, text=True, timeout=360, cwd=harness.ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
