"""The yardstick (`bench/roofline.py`) against counts made by hand, and the
trace reader (`bench/trace.py`) on a handful of made-up profiler events:
which host operator each device operation is charged to, busy and idle
time, and the shares the readers compute from them."""
from __future__ import annotations

import dataclasses
import importlib

import pytest
from torch.autograd import DeviceType

from bench import readers, roofline, trace

BF16, F32 = "c10::BFloat16", "float"
FLASH = "repro_torch::flash_attention_fwd"


def test_visible_pairs_by_hand():
    assert roofline.visible_pairs(4, 4, causal=True) == 10
    assert roofline.visible_pairs(4, 4, causal=False) == 16
    assert roofline.visible_pairs(4, 4, causal=True, window=2) == 1 + 2 + 2 + 2
    assert roofline.visible_pairs(2, 6, causal=True, q_offset=4) == 5 + 6


def test_flash_bound_by_hand():
    by, ops = roofline.flash_bound([1, 4, 2, 8], [1, 4, 1, 8], [1, 4, 1, 8], BF16)
    assert ops == 2 * (8 + 8) * 1 * 2 * 10
    assert by == 2 * (1 * 4 * 2 * 8 + 1 * 4 * 1 * (8 + 8) + 1 * 4 * 2 * 8)
    t, kind = roofline.call_bound_s(FLASH, [[1, 4, 2, 8], [1, 4, 1, 8], [1, 4, 1, 8],
                                            [], [], []], [BF16] * 3 + ["Scalar"] * 3,
                                    [None, None, None, True, 0, 0])
    assert kind == "bytes" and t == pytest.approx(by / 3.35e12)
    # at a long sequence the operations bind, at bf16's tensor-core peak
    q = [8, 2048, 16, 128]
    t, kind = roofline.call_bound_s(FLASH, [q, q, q, [], [], []], [BF16] * 3, [])
    assert kind == "operations"
    assert t == pytest.approx(2 * 256 * 8 * 16 * (2048 * 2049 // 2) / 989e12)


def test_every_roofline_metric_has_a_bound_for_each_of_its_operators():
    from bench import harness
    for m in harness.benchmark()["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline"):
            ops = harness.metric_reader(m["name"]).__globals__["OPS"]
            for op in ops:
                assert importlib.import_module(f"bench.bounds.{op.split('::')[1]}").bound


def test_an_operator_without_a_bound_file_has_no_bound():
    with pytest.raises(KeyError, match="no bench/bounds/rwkv6_scan_fwd.py"):
        roofline.call_bound_s("repro_torch::rwkv6_scan_fwd", [[1]], [F32], [])


@pytest.mark.parametrize("name,shapes,dtypes,want", [
    ("sq_norm", [[1000]], [F32], 4000 + 4),
    ("fused_axpy", [[], [1000], [1000], [1000]], [F32] * 4, 2 * 4000 + 4000),
    ("fused_dot_norms", [[1000], [1000]], [F32] * 2, 8000 + 12),
    ("adamw_epilogue", [[1000]] * 4 + [[5]], [F32] * 5, 4 * 4000 + 20 + 3 * 4000),
    ("sgd_epilogue", [[1000], [1000], [1000], [4]], [F32] * 4, 3 * 4000 + 16 + 2 * 4000),
    ("sam_perturb", [[1000], [1000], [], [], [], [1000]], [F32] * 6, 2 * 4000 + 4000),
])
def test_epilogue_bytes_by_hand(name, shapes, dtypes, want):
    assert importlib.import_module(f"bench.bounds.{name}").bound(shapes, dtypes, [])[0] == want
    t, kind = roofline.call_bound_s(f"repro_torch::{name}", shapes, dtypes, [])
    assert kind == "bytes" and t == pytest.approx(want / 3.35e12)


@dataclasses.dataclass
class Ev:
    """A made-up raw profiler event with the methods `trace.read` calls."""
    n: str
    s: int
    e: int
    kind: str = "cpu_op"
    dev: object = DeviceType.CPU
    corr: int = 0
    link: int = 0
    thread: int = 1
    shp: list = dataclasses.field(default_factory=list)
    dt: list = dataclasses.field(default_factory=list)

    def name(self): return self.n
    def start_ns(self): return self.s
    def duration_ns(self): return self.e - self.s
    def activity_type(self): return self.kind
    def device_type(self): return self.dev
    def correlation_id(self): return self.corr
    def linked_correlation_id(self): return self.link
    def start_thread_id(self): return self.thread
    def shapes(self): return self.shp
    def dtypes(self): return self.dt
    def concrete_inputs(self): return [None] * len(self.shp)


class Legacy:
    """An event as an older profiler gives it: no activity type."""
    def __init__(self, ev):
        self.ev = ev

    def __getattr__(self, name):
        if name in ("activity_type", "is_user_annotation"):
            raise AttributeError(name)
        return getattr(self.ev, name)


def made_up_trace(legacy: bool = False) -> trace.Trace:
    cuda = DeviceType.CUDA
    flash_q = [1, 64, 2, 16]
    wrap = Legacy if legacy else (lambda e: e)
    return trace.read(wrap(e) for e in [
        Ev(trace.WINDOW, 0, 1000, kind="user_annotation"),
        Ev("aten::outer", 50, 950, corr=1),
        Ev("repro_torch::fused_axpy", 100, 200, corr=5, shp=[[], [1000], [1000], [1000]],
           dt=[F32] * 4),
        Ev("repro_torch::flash_attention_fwd", 500, 600, corr=6,
           shp=[flash_q, flash_q, flash_q, [], [], []], dt=[BF16] * 3),
        Ev("repro_torch::flash_attention_fwd", 505, 595, corr=7,       # a dispatch mode's
           shp=[flash_q, flash_q, flash_q, [], [], []], dt=[BF16] * 3),
        Ev(trace.WINDOW, 0, 1000, dev=DeviceType.CUDA, corr=101),  # the annotation on the card
        Ev("cudaLaunchKernel", 550, 560, kind="cuda_runtime", corr=77),
        Ev("void axpy_kernel<float>(...)", 300, 400, dev=cuda, corr=70, link=5),
        Ev("void fa_fwd_wgmma_kernel<...>(...)", 610, 700, dev=cuda, corr=77),
        Ev("ssd_bwd_chunk_kernel", 800, 900, dev=cuda, corr=99),
        Ev("Memset (Device)", 1200, 1300, dev=cuda, corr=100),      # after the window
    ])


@pytest.mark.parametrize("legacy", [False, True])
def test_device_operations_are_charged_to_their_host_operator(legacy):
    tr = made_up_trace(legacy)
    how = {d.name.split("<")[0].split("(")[0].strip(): (d.op.name, d.how) for d in tr.device}
    assert how == {"void axpy_kernel": ("repro_torch::fused_axpy", "link"),
                   "void fa_fwd_wgmma_kernel": ("repro_torch::flash_attention_fwd", "launch"),
                   "ssd_bwd_chunk_kernel": ("repro_torch::mamba2_scan_bwd", "table")}
    assert tr.attribution == {"link": 1, "launch": 1, "table": 1}


def test_busy_idle_and_breakdown():
    tr = made_up_trace()
    assert tr.window_s == pytest.approx(1e-6)
    assert tr.busy_s() == pytest.approx(290e-9)
    gaps = dict(tr.idle_gaps())
    # the gaps [0, 300), [400, 610), [700, 800), [900, 1000): at their
    # middles the innermost operator is the axpy (150), aten::outer (505
    # is inside the flash op: 505), ...
    assert sum(gaps.values()) == pytest.approx(710e-9)
    assert gaps["repro_torch::fused_axpy"] == pytest.approx(300e-9)
    assert gaps["repro_torch::flash_attention_fwd"] == pytest.approx(210e-9)
    assert gaps["aten::outer"] == pytest.approx(200e-9)
    assert tr.top_device_ops()[0][1] == pytest.approx(100e-9)


def test_an_operator_recorded_inside_itself_is_one_call():
    tr = made_up_trace()
    calls = tr.calls((FLASH,))
    assert [(c.start, c.end) for c in calls] == [(505, 595)]


def test_readers_on_the_made_up_trace():
    run = type("Run", (), {})()
    run.trace, run.traced_flops, run.notes = made_up_trace(), 989e12 * 1e-7, []
    assert readers.idle_share(run) == pytest.approx(71.0)
    assert readers.mfu(run) == pytest.approx(10.0)
    axpy = 12000 / 3.35e12
    assert readers.roofline_share(run, "x", ("repro_torch::fused_axpy",)) == pytest.approx(
        100 * axpy / 100e-9)
    assert readers.roofline_share(run, "y", ("repro_torch::rwkv6_scan_fwd",)) is None
    assert run.notes and "bound by" in run.notes[0]
