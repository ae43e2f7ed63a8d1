"""What the per-layer metrics' readers (`bench/metrics/<metric>.py`) share.
Each takes the run (`harness.Outcome`) and returns a number, or None where
the traced run holds nothing to read."""
from __future__ import annotations

from bench import roofline


def idle_share(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def mfu(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or run.traced_flops <= 0:
        return None
    return 100.0 * run.traced_flops / (tr.window_s * roofline.PEAK_FLOPS["bfloat16"])


def roofline_share(run, name: str, ops: tuple[str, ...]):
    if run.trace is None:
        return None
    got = roofline.share(run.trace, ops)
    if got is None:
        return None
    value, bound_by = got
    run.notes.append(f"{name}: {len(run.trace.calls(ops))} calls, bound by {bound_by}, "
                     f"{run.trace.device_s(ops):.6f} device s")
    return value
