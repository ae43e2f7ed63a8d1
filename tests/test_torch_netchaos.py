"""Port parity for the wire chaos harness and the lane degradation ladder:
`service.netchaos` (FaultSchedule, parse_faults, ChaosProxy) and
`runtime.health` (LaneHealth, LaneLadder, ServerWatchdog), each held against
the reference's, then the reference's proxy and ladder scenarios run against
the port's ascent server, client and executors.

Tolerances, per check: the schedules, the health window, the ladder and the
watchdog are host logic and must fire the reference's sequences exactly for
one seed (and injected clocks and scrapes); the lockstep run under
transient wire faults equals the undisturbed run bit for bit; every socket
wait has a deadline and each test its own time limit.
"""
import functools
import signal
import socket
import threading
import time

import numpy as np
import pytest
import torch

from repro.runtime import LaneHealth as JLaneHealth
from repro.runtime import LaneLadder as JLaneLadder
from repro.runtime import RestartBudget as JRestartBudget
from repro.runtime import ServerWatchdog as JServerWatchdog
from repro.service.netchaos import parse_faults as jparse_faults
from repro_torch import optim
from repro_torch.core import Compressor, MethodConfig, slice_ascent_batch
from repro_torch.data.synthetic import ClassificationTask
from repro_torch.engine import Engine, GuardConfig, GuardedExecutor, RemoteExecutor
from repro_torch.runtime import (ExecutorConfig, LaneHealth, LaneLadder, RestartBudget,
                                 ServerWatchdog)
from repro_torch.service.ascent_server import AscentServer
from repro_torch.service.client import RemoteAscentClient
from repro_torch.service.netchaos import ChaosProxy, FaultRule, FaultSchedule, parse_faults
from repro_torch.service.testing import mlp_init, mlp_loss

TASK = ClassificationTask(n_classes=4, dim=8, seed=3)
KEY = np.array([0, 5], np.uint32)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """A few intra-op threads: the suite runs files side by side in several
    workers, and the JAX tests beside these time their own threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def time_limit(seconds: int):
    """Fail a test that runs past `seconds` (SIGALRM in the main thread, where
    pytest runs tests): a wedged socket must not hang the suite."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            def expire(signum, frame):
                raise TimeoutError(f"{fn.__name__} ran past its {seconds} s limit")
            old = signal.signal(signal.SIGALRM, expire)
            signal.alarm(seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, old)
        return run
    return wrap


def _params():
    return mlp_init(0, (8, 32, 4), device="cpu")


def _batches(n, frac=0.5, nan_at=()):
    out = []
    for i, b in enumerate(TASK.train_batches(64, n, device="cpu")):
        if i in nan_at:
            b = {**b, "x": torch.full_like(b["x"], float("nan"))}
        out.append({**b, "ascent": slice_ascent_batch(b, frac)})
    return out


def _mcfg():
    return MethodConfig(name="async_sam", rho=0.05, ascent_fraction=0.5)


def _server():
    server = AscentServer(mlp_loss, device="cpu")
    server.serve_in_thread()
    return server


# ---------------------------------------------------------------------------
# FaultSchedule and its grammar: the reference's sequences
# ---------------------------------------------------------------------------

_SPECS = [
    "corrupt:GRAD:nth=2,drop:GRAD:every=3:count=1,delay:JOB_DELTA",
    "delay:*:prob=0.3:delay_s=0.1,corrupt:GRAD:prob=0.2,drop:HELLO:direction=c2s",
    "corrupt:GRAD:nth=1,corrupt:GRAD:nth=2,truncate:GRAD:nth=3,"
    "blackhole:GRAD:nth=4:duration_s=0.2,duplicate:GRAD:nth=6,"
    "delay:GRAD:nth=7:delay_s=0.03,drop:JOB_DELTA:nth=9,stall:JOB_DELTA:nth=11:delay_s=0.03",
]


@pytest.mark.parametrize("spec", _SPECS)
@pytest.mark.parametrize("seed", [0, 7])
def test_fault_schedule_fires_the_reference_sequence(spec, seed):
    frames = [("s2c", "GRAD"), ("c2s", "JOB_DELTA"), ("c2s", "HELLO"), ("s2c", "HELLO_ACK"),
              ("c2s", "JOB"), ("s2c", "GRAD")]
    rng = np.random.default_rng(seed)
    order = [frames[i] for i in rng.integers(0, len(frames), 200)]
    sched, jsched = parse_faults(spec, seed=seed), jparse_faults(spec, seed=seed)
    got = [getattr(sched.fire(d, f), "action", None) for d, f in order]
    want = [getattr(jsched.fire(d, f), "action", None) for d, f in order]
    assert got == want and any(got)
    assert sched.fired_actions() == jsched.fired_actions()
    assert [(r.seen, r.fired) for r in sched.rules] == [(r.seen, r.fired)
                                                         for r in jsched.rules]


def test_fault_rules_first_firing_rule_wins():
    sched = FaultSchedule([FaultRule("corrupt", frame="GRAD", nth=2),
                           FaultRule("drop", frame="GRAD", every=3, count=1),
                           FaultRule("delay", frame="JOB_DELTA")])
    fired = [sched.fire("s2c", "GRAD") for _ in range(7)]
    assert [f.action if f else None for f in fired] == \
        [None, "corrupt", None, "drop", None, None, None]
    assert sched.fire("c2s", "JOB_DELTA").action == "delay"
    assert sched.fire("c2s", "HELLO") is None


def test_parse_faults_grammar():
    sched = parse_faults("corrupt:GRAD:nth=2,delay:*:prob=0.25:delay_s=0.1,"
                         "blackhole:GRAD:nth=4:duration_s=0.5,drop:HELLO:direction=c2s")
    assert [(r.action, r.frame) for r in sched.rules] == [
        ("corrupt", "GRAD"), ("delay", "*"), ("blackhole", "GRAD"), ("drop", "HELLO")]
    assert sched.rules[1].prob == 0.25 and sched.rules[2].duration_s == 0.5
    assert sched.rules[3].direction == "c2s"
    with pytest.raises(ValueError, match="unknown fault action"):
        parse_faults("explode:GRAD")
    with pytest.raises(ValueError, match="unknown fault option"):
        parse_faults("drop:GRAD:when=later")


# ---------------------------------------------------------------------------
# LaneHealth, LaneLadder, ServerWatchdog: the reference's sequences
# ---------------------------------------------------------------------------

def test_lane_health_matches_reference_under_one_clock():
    rng = np.random.default_rng(4)
    now = [0.0]
    hs = [cls(window=6, error_threshold=0.5, min_samples=3, stall_timeout_s=2.0,
              clock=lambda: now[0]) for cls in (LaneHealth, JLaneHealth)]
    trace = [[], []]
    for _ in range(300):
        op = rng.integers(0, 5)
        now[0] += float(rng.uniform(0, 1.2))
        reset = rng.random() < 0.05
        for h, out in zip(hs, trace):
            if op == 0:
                h.note_submit()
            elif op in (1, 2):
                h.record(bool(op == 1), rtt_s=float(now[0] % 1.0))
            elif op == 3 and reset:
                h.reset()
            out.append((h.unhealthy(), h.stalled(), h.error_rate(), h.mean_rtt_s(),
                        h.successes, h.failures))
    assert trace[0] == trace[1]
    assert any(t[0] for t in trace[0]) and any(t[1] for t in trace[0])


def test_lane_ladder_matches_reference():
    rng = np.random.default_rng(5)
    lads = [cls(n_levels=3, probation_steps=4, cooldown_steps=2, max_cooldown_steps=16)
            for cls in (LaneLadder, JLaneLadder)]
    trace = [[], []]
    for _ in range(400):
        op = rng.integers(0, 4)
        for lad, out in zip(lads, trace):
            lad.tick()
            r = lad.demote() if op == 0 else lad.promote() if op == 1 else None
            out.append((r, lad.level, lad.failovers, lad.recoveries, lad.in_probation,
                        lad.can_promote()))
    assert trace[0] == trace[1]
    assert lads[0].failovers > 5 and lads[0].recoveries > 5


def _watchdog_run(wd_cls, budget_cls, feed, wedge_scrapes=3, budget=2):
    verdicts = []
    it = iter(feed)

    def stats(addr):
        snap = next(it)
        if snap is None:
            raise ConnectionError("refused")
        return snap

    wd = wd_cls(lambda: "x", verdicts.append, budget_cls(budget, what="server restart"),
                wedge_scrapes=wedge_scrapes, stats_fn=stats)
    return [wd.check() for _ in feed], verdicts, wd.restarts


def test_server_watchdog_matches_reference(capsys):
    rng = np.random.default_rng(6)
    feed, ex = [], 0
    for _ in range(120):
        r = rng.random()
        if r < 0.08:
            feed.append(None)                             # dead scrape
        else:
            ex += int(rng.integers(0, 2)) if r < 0.7 else 0
            feed.append({"exchanges": ex, "queue_depth": int(rng.integers(0, 3))})
    got = _watchdog_run(ServerWatchdog, RestartBudget, feed)
    want = _watchdog_run(JServerWatchdog, JRestartBudget, feed)
    assert got == want
    assert {"ok", "dead", "wedged"} <= set(got[0]) and got[2] == 2   # budget bounds it


@time_limit(60)
def test_watchdog_live_scrape_against_the_port_server():
    server = _server()
    try:
        wd = ServerWatchdog(lambda: server.address, lambda v: None,
                            RestartBudget(1, what="server restart"))
        assert wd.check() == "ok"
    finally:
        server.close()


# ---------------------------------------------------------------------------
# ChaosProxy against the port's server and client
# ---------------------------------------------------------------------------

@time_limit(120)
def test_proxy_passthrough_preserves_the_exchange():
    server = _server()
    proxy = ChaosProxy(server.address, FaultSchedule([]))
    client = RemoteAscentClient(proxy.addr, Compressor("none"))
    try:
        batch = _batches(1)[0]["ascent"]
        assert client.submit(0, _params(), batch, KEY, 0)
        got = client.poll(block=True, timeout=60.0)
        assert got is not None and got[1] is not None
        assert proxy.connections == 1
        assert proxy.frames.get(("c2s", "HELLO")) == 1
        assert proxy.frames.get(("s2c", "GRAD")) == 1
    finally:
        client.close()
        proxy.close()
        server.close()


@time_limit(120)
def test_proxy_corrupt_frame_is_lost_exchange_not_poison():
    server = _server()
    proxy = ChaosProxy(server.address, FaultSchedule([FaultRule("corrupt", frame="GRAD",
                                                                nth=1)]))
    client = RemoteAscentClient(proxy.addr, Compressor("none"), reconnect_backoff_s=0.05)
    try:
        params, batch = _params(), _batches(1)[0]["ascent"]
        assert client.submit(0, params, batch, KEY, 0)
        got = client.poll(block=True, timeout=60.0)
        assert got is not None and got[1] is None       # lost, not hung
        deadline = time.monotonic() + 60.0
        while not client.submit(0, params, batch, np.array([0, 6], np.uint32), 1):
            assert time.monotonic() < deadline
            time.sleep(0.02)
        got = client.poll(block=True, timeout=60.0)
        assert got is not None and got[1] is not None   # recovered
        assert client.drops >= 1 and ("s2c", "GRAD", "corrupt") in proxy.faults
    finally:
        client.close()
        proxy.close()
        server.close()


@time_limit(180)
def test_ladder_fails_over_to_local_lane_when_remote_is_dead():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    dead_addr = "127.0.0.1:%d" % probe.getsockname()[1]
    probe.close()
    xcfg = ExecutorConfig(ascent_addr=dead_addr, connect_timeout_s=1.0,
                          reconnect_backoff_s=0.1, max_staleness=3, lane_ladder=True,
                          health_window=4, health_min_samples=2,
                          health_stall_timeout_s=3.0, ladder_cooldown_steps=10_000)
    hist = []
    with RemoteExecutor(mlp_loss, _mcfg(), optim.sgd(0.1, momentum=0.9),
                        exec_cfg=xcfg) as ex:
        state = ex.init_state(_params(), 1)
        deadline = time.monotonic() + 120.0
        for b in _batches(2000):
            state, m = ex.step(state, b)
            hist.append(m)
            if m["lane_state"] == 1.0 and m["perturbed"] == 1.0:
                break
            assert time.monotonic() < deadline, "no failover within the deadline"
            time.sleep(0.02)
    assert ex._inner._ladder.failovers >= 1
    assert hist[0]["lane_state"] == 0.0
    assert hist[-1]["lane_state"] == 1.0 and hist[-1]["perturbed"] == 1.0
    assert any(m.get("lane_failovers", 0) >= 1 for m in hist)
    assert all(np.isfinite(float(m["loss"])) for m in hist)


def _paced(batches, pace_s):
    for b in batches:
        time.sleep(pace_s)
        yield b


@time_limit(240)
def test_soak_hostile_schedule_completes_with_failover_and_recovery():
    server = _server()
    sched = parse_faults(_SPECS[2], seed=5)
    proxy = ChaosProxy(server.address, sched)
    xcfg = ExecutorConfig(ascent_addr=proxy.addr, reconnect_backoff_s=0.05, max_staleness=3,
                          lane_ladder=True, health_window=4, health_error_threshold=0.5,
                          health_min_samples=2, health_stall_timeout_s=5.0,
                          ladder_cooldown_steps=5, ladder_probation_steps=3)
    try:
        with RemoteExecutor(mlp_loss, _mcfg(), optim.sgd(0.1, momentum=0.9),
                            exec_cfg=xcfg) as ex:
            state = ex.init_state(_params(), 1)
            report = Engine(ex, _paced(_batches(90), 0.015)).fit(state, 90)
            ladder = ex._inner._ladder
        hist = report.metrics_history
        assert len(hist) == 90 and all(np.isfinite(m["loss"]) for m in hist)
        assert ladder.failovers >= 1 and ladder.recoveries >= 1, \
            (ladder.failovers, ladder.recoveries, sched.fired_actions())
        assert max(m.get("lane_failovers", 0) for m in hist) >= 1
        assert max(m.get("lane_recoveries", 0) for m in hist) >= 1
        assert hist[-1]["lane_state"] == 0.0
        assert proxy.fault_count() >= 4 and len({a for _, _, a in proxy.faults}) >= 3
    finally:
        proxy.close()
        server.close()
    leftovers = [t.name for t in threading.enumerate()
                 if not t.daemon and t is not threading.main_thread()]
    assert leftovers == [], leftovers


@time_limit(240)
def test_transient_faults_are_bitwise_invisible_under_lockstep():
    def run(spec):
        server = _server()
        proxy = ChaosProxy(server.address, parse_faults(spec))
        xcfg = ExecutorConfig(lockstep=True, ascent_addr=proxy.addr, reconnect_backoff_s=0.05)
        losses = []
        try:
            with RemoteExecutor(mlp_loss, _mcfg(), optim.sgd(0.1, momentum=0.9),
                                exec_cfg=xcfg) as ex:
                state = ex.init_state(_params(), 1)
                for b in _batches(12):
                    state, m = ex.step(state, b)
                    losses.append(float(m["loss"]))
                retried = ex.client.retried_exchanges
            faults = proxy.fault_count()
        finally:
            proxy.close()
            server.close()
        return losses, retried, faults

    base, base_retried, base_faults = run("")
    hit, hit_retried, hit_faults = run(
        "delay:GRAD:nth=2:delay_s=0.05,stall:GRAD:nth=4:delay_s=0.05,drop:GRAD:nth=6,"
        "corrupt:GRAD:nth=7,stall:JOB_DELTA:nth=3:delay_s=0.05,drop:JOB_DELTA:nth=9")
    assert base_faults == 0 and hit_faults >= 4
    assert base_retried == 0 and hit_retried >= 2
    assert np.array_equal(np.asarray(base), np.asarray(hit)), (base, hit)


@time_limit(240)
def test_guard_and_lane_ladder_recover_independently():
    """Numeric de-escalation while the remote lane is itself demoted under
    wire chaos: the two ladders act on different failure domains and both
    recover (the reference's tests/test_guard.py scenario)."""
    server = _server()
    sched = parse_faults("corrupt:GRAD:nth=1,corrupt:GRAD:nth=2,truncate:GRAD:nth=3,"
                         "blackhole:GRAD:nth=4:duration_s=0.2", seed=5)
    proxy = ChaosProxy(server.address, sched)
    xcfg = ExecutorConfig(ascent_addr=proxy.addr, reconnect_backoff_s=0.05, max_staleness=3,
                          lane_ladder=True, health_window=4, health_error_threshold=0.5,
                          health_min_samples=2, health_stall_timeout_s=5.0,
                          ladder_cooldown_steps=5, ladder_probation_steps=3,
                          guard_update=True)
    gcfg = GuardConfig(rho_scales=(1.0, 0.5), demote_after=2, anomaly_window=4,
                       probation_steps=3, cooldown_steps=5, spike_min_samples=8,
                       rollback=False)
    hist = []
    try:
        with RemoteExecutor(mlp_loss, _mcfg(), optim.sgd(0.1, momentum=0.9),
                            exec_cfg=xcfg) as ex:
            g = GuardedExecutor(ex, gcfg)
            lane = ex._inner._ladder
            state = g.init_state(_params(), 1)
            deadline = time.monotonic() + 150.0
            batches = _batches(2000, nan_at=(8, 9))
            for i, b in enumerate(batches):
                state, m = g.step(state, b)
                hist.append(m)
                if (i >= 39 and lane.failovers >= 1 and lane.recoveries >= 1
                        and g.ladder.failovers >= 1 and g.ladder.recoveries >= 1
                        and m["lane_state"] == 0.0 and m["guard_state"] == 0.0):
                    break
                assert time.monotonic() < deadline, (
                    f"lane=({lane.failovers},{lane.recoveries}) "
                    f"guard=({g.ladder.failovers},{g.ladder.recoveries})")
                time.sleep(0.015)
    finally:
        proxy.close()
        server.close()
    assert max(m["lane_state"] for m in hist) >= 1
    assert max(m["guard_state"] for m in hist) >= 1
    assert max(m.get("steps_skipped", 0) for m in hist) >= 1
    assert proxy.fault_count() >= 4
    assert all(np.isfinite(float(m["loss"])) for m in hist
               if not float(m.get("update_skipped", 0)))
