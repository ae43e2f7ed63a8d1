"""Shared pytest fixtures.

Device count stays 1 here (the dry-run sets its own XLA_FLAGS in a subprocess;
smoke tests and benches must see the real single CPU device). Mesh-dependent
tests spawn subprocesses via `run_py` with their own device-count flags.
"""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]

# REPRO_FUSED=1 (scripts/tier1.sh --resident): force the fused flat-buffer
# weight-space path on and run its kernels as real Pallas code in interpret
# mode, so the bucket-resident parity/interop tests exercise the kernel
# implementations on CPU instead of the jnp oracles. Tests that pin explicit
# fused=False/True flags are unaffected (explicit override beats the default).
if os.environ.get("REPRO_FUSED") == "1":
    from repro.kernels import ops as _ops
    from repro.utils import buckets as _buckets

    _buckets.set_fused_default(True)
    _ops.set_default_impl("pallas_interpret")

# REPRO_KERNELS=interpret (scripts/tier1.sh --service): run every dispatched
# kernel as real Pallas code in interpret mode WITHOUT forcing the fused
# weight-space default — the service lane uses this so the JOB delta-encode
# kernels (ops.delta_amax / delta_encode_i8) exercise the Pallas
# implementations on CPU while executor behavior stays the platform default.
elif os.environ.get("REPRO_KERNELS") == "interpret":
    from repro.kernels import ops as _ops

    _ops.set_default_impl("pallas_interpret")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's Hopper kernels); "
        "skips where torch.cuda.is_available() is false")


@pytest.fixture(scope="session")
def repo_root() -> pathlib.Path:
    return REPO


def run_py(code: str, devices: int = 8, timeout: int = 560) -> str:
    """Run `code` in a fresh python with a fake multi-device CPU platform."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = str(REPO / "src")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        capture_output=True, text=True, timeout=timeout, env=env)
    assert proc.returncode == 0, f"subprocess failed:\n{proc.stdout}\n{proc.stderr}"
    return proc.stdout


@pytest.fixture
def subprocess_py():
    return run_py
