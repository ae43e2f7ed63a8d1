"""The traced stretch of a run: `torch.profiler` over a few steps or batches
of the window, read from its raw (kineto) events, never from the event
tree, which costs ten times as long to build.

`Profile` starts and stops the profiler around the stretch and marks it
with a user annotation ("bench.window"), whose span is the traced window.
`read` turns the events into a `Trace`: the device operations (kernels,
copies, fills), the host's operators, and for each device operation the
host operator that launched it:

* "link": the operation's linked correlation id, which the profiler sets
  to the id of the innermost host operator open when it was launched;
* "launch": else its runtime launch (same correlation id) and the
  innermost operator on the launching thread enclosing that launch;
* "table": else the first entry of `kernel_ops.json` whose key the
  operation's name contains.

Every reader of a per-layer metric takes what it needs from a `Trace`.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import pathlib
from typing import Optional

WINDOW = "bench.window"
KERNEL_OPS = pathlib.Path(__file__).with_name("kernel_ops.json")


@dataclasses.dataclass
class Op:
    name: str
    start: int                 # ns
    end: int
    thread: int
    corr: int
    shapes: list
    dtypes: list
    inputs: list               # concrete scalar inputs, None where a tensor


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: int
    end: int
    op: Optional[Op] = None    # the host operator that launched it
    how: str = ""              # "link", "launch", "table" or "" (none)


@dataclasses.dataclass
class Trace:
    window: tuple[int, int]            # the traced window, ns
    device: list[DeviceOp]             # inside the window
    ops: list[Op]                      # host operators inside the window
    attribution: dict[str, int]        # device operations by how they were charged

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device operations' intervals, clipped to the
        window."""
        lo, hi = self.window
        spans = sorted((max(d.start, lo), min(d.end, hi)) for d in self.device)
        out: list[list[int]] = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def calls(self, names: tuple[str, ...]) -> list[Op]:
        """The calls of the host operators named in `names` that started
        inside the window: an operator recorded again inside itself (a
        dispatch mode, such as selective checkpointing's, runs it once
        more) is one call, the innermost."""
        ops = sorted((o for o in self.ops if o.name in names),
                     key=lambda o: (o.thread, o.name, o.start))
        return [o for o, nxt in zip(ops, ops[1:] + [None])
                if nxt is None or (nxt.thread, nxt.name) != (o.thread, o.name)
                or nxt.start > o.end]

    def device_s(self, names: tuple[str, ...]) -> float:
        """Device seconds of the operations charged to those operators."""
        return sum(d.end - d.start for d in self.device
                   if d.op is not None and d.op.name in names) / 1e9

    def top_device_ops(self, n: int = 10) -> list[list]:
        by: dict[str, float] = collections.defaultdict(float)
        for d in self.device:
            by[d.name] += (d.end - d.start) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The idle time between device operations inside the window,
        summed by the host operator running at each gap's middle (the
        innermost: the latest-started one enclosing it, on any thread),
        longest first."""
        lo, hi = self.window
        gaps, t = [], lo
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        mids = [(a + b) // 2 for a, b in gaps]
        best: list[Optional[Op]] = [None] * len(gaps)
        threads: dict[int, list[Op]] = collections.defaultdict(list)
        for o in self.ops:
            threads[o.thread].append(o)
        for ops in threads.values():
            ops.sort(key=lambda o: o.start)
            stack: list[Op] = []
            i = 0
            for g, mid in enumerate(mids):        # in time order: sweep the operators
                while i < len(ops) and ops[i].start <= mid:
                    while stack and stack[-1].end < ops[i].start:
                        stack.pop()
                    stack.append(ops[i])
                    i += 1
                while stack and stack[-1].end < mid:
                    stack.pop()
                if stack and (best[g] is None or stack[-1].start > best[g].start):
                    best[g] = stack[-1]
        by: dict[str, float] = collections.defaultdict(float)
        for (a, b), op in zip(gaps, best):
            by[op.name if op is not None else "(no operator)"] += (b - a) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


class Profile:
    """The profiler over a stretch: `start()` before its first step,
    `stop()` after its last one has synchronized."""

    def __init__(self):
        self.prof = None
        self.mark = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                            record_shapes=True)
        self.prof.start()
        torch.cuda.synchronize()
        self.mark = record_function(WINDOW)
        self.mark.__enter__()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        self.mark = None
        self.prof.stop()

    @property
    def active(self) -> bool:
        return self.mark is not None


RUNTIME_PREFIXES = ("cuda", "cu")


def _kind(e) -> str:
    """"cpu_op", "user_annotation" or "cuda_runtime" of a host event; from
    its activity type where the profiler gives one, else from its name (a
    runtime or driver call's starts with "cuda" or "cu", an operator's holds
    "::")."""
    activity = getattr(e, "activity_type", None)
    if activity is not None:
        return activity()
    if getattr(e, "is_user_annotation", lambda: False)() or e.name() == WINDOW:
        return "user_annotation"
    name = e.name()
    if "::" not in name and name.startswith(RUNTIME_PREFIXES):
        return "cuda_runtime"
    return "cpu_op"


def _end(e) -> int:
    return e.start_ns() + e.duration_ns()


def _concrete(e) -> list:
    try:
        return list(e.concrete_inputs())
    except (AttributeError, RuntimeError):
        return []


def _table() -> list[tuple[str, str]]:
    return list(json.loads(KERNEL_OPS.read_text()).items())


def read(events) -> Trace:
    """A `Trace` from the profiler's raw events (`prof.profiler.
    kineto_results.events()`), or from objects with the same methods."""
    from torch.autograd import DeviceType
    ops, device, launches, window = [], [], {}, None
    by_corr: dict[int, Op] = {}
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if e.name() != WINDOW:          # the annotation's span on the device's timeline
                device.append((e, DeviceOp(e.name(), e.start_ns(), _end(e))))
            continue
        kind = _kind(e)
        if kind == "user_annotation" and e.name() == WINDOW:
            window = (e.start_ns(), _end(e))
        elif kind == "cpu_op":
            op = Op(e.name(), e.start_ns(), _end(e), e.start_thread_id(), e.correlation_id(),
                    list(e.shapes()), list(e.dtypes()), _concrete(e))
            ops.append(op)
            by_corr[op.corr] = op
        elif kind in ("cuda_runtime", "cuda_driver"):
            launches[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
    if window is None:
        raise ValueError(f"the trace holds no '{WINDOW}' annotation")
    by_thread: dict[int, list[Op]] = collections.defaultdict(list)
    for op in ops:
        by_thread[op.thread].append(op)
    for lst in by_thread.values():
        lst.sort(key=lambda o: o.start)
    starts = {t: [o.start for o in lst] for t, lst in by_thread.items()}
    table = _table()
    counts: dict[str, int] = collections.Counter()
    lo, hi = window
    kept = []
    for e, d in device:
        if d.end <= lo or d.start >= hi:
            continue
        op = by_corr.get(e.linked_correlation_id())
        how = "link" if op is not None else ""
        if op is None and e.correlation_id() in launches:
            t, thread = launches[e.correlation_id()]
            lst = by_thread.get(thread, [])
            i = bisect.bisect_right(starts[thread], t) if lst else 0
            for cand in reversed(lst[max(0, i - 512):i]):   # innermost: latest start
                if cand.end >= t:
                    op, how = cand, "launch"
                    break
        if op is None:
            name = next((v for k, v in table if k in d.name), None)
            if name is not None:
                op, how = Op(name, d.start, d.end, -1, -1, [], [], []), "table"
        d.op, d.how = op, how
        counts[how or "none"] += 1
        kept.append(d)
    return Trace(window=window, device=kept,
                 ops=[o for o in ops if lo <= o.start < hi], attribution=dict(counts))
