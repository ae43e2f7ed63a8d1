"""Fixtures of the benchmark's CPU tests: small cells of the reduced
presets, run on the CPU through the harness's own code."""
from __future__ import annotations

import dataclasses
import pathlib
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's Hopper kernels); "
        "skips where torch.cuda.is_available() is false")


# the cells' traffic cut to a size the CPU runs in a second or two
SMALL = {"train": {"seq": 32, "ref_rows": 4},
         "prefill": {"token_budget": 64, "lengths": [32], "per_cycle": [1],
                     "check_per_length": 4, "ref_tokens": 64, "trace_batches": [2, 4]}}


def small_context(workload: str, seed: int = 2**31 + 11, seconds: float = 0.5):
    """The harness's Context of cell `workload` on the CPU: its traffic cut
    by SMALL, the program's and the reference's config the reduced preset
    of the cell's arch, its limits the cell's own."""
    import torch

    from bench import harness
    from repro_torch.configs import get_config
    bench = harness.benchmark()
    _, cfg, traffic, limits = harness.cell_files(workload, bench)
    small = {"arch": cfg["arch"], "preset": "reduced",
             **dataclasses.asdict(get_config(cfg["arch"], reduced=True))}
    traffic = {**traffic, **SMALL[traffic["kind"]]}
    return harness.Context(workload, seed, seconds, False, torch.device("cpu"), small, traffic,
                           limits, time.perf_counter())


@pytest.fixture
def small_ctx():
    return small_context


@pytest.fixture
def card():
    """Skips unless this machine has a CUDA card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
