"""Lane health tracking, the ascent-lane degradation ladder and the server
watchdog (counterpart of `repro.runtime.health`, plain Python, the same
logic).

Three cooperating pieces that turn the executor's per-exchange outcomes into
an explicit, observable failure-response policy instead of an implicit one:

`LaneHealth`
    Rolling-window accounting over `ascent_exchange` outcomes: error rate,
    RTT, and silence. A lost exchange (the lane's grad=None sentinel, or a
    lockstep harvest timeout) records a failure; a harvested gradient records
    a success with its round-trip time. `stalled()` catches the failure mode
    error counting cannot: a blackholed connection that produces neither
    results nor errors while an exchange is outstanding.

`LaneLadder`
    The degradation policy itself, pure step-count logic with no I/O so it is
    exhaustively unit-testable: level 0 is the primary (remote) lane, each
    `demote()` moves one rung down (remote -> in-process thread lane ->
    ledger-only descent) and each `promote()` one rung back up. Hysteresis
    comes from two counters: a cooldown that must elapse before any
    promotion is attempted, and a probation window after every promotion —
    a demotion landing inside probation doubles the next cooldown, so a
    flapping upstream converges to the working rung instead of oscillating.

`ServerWatchdog`
    Scrapes the pool's revision-4 STATS frame through an observer HELLO
    (the port's `service.client.fetch_pool_stats`, which reads a pool server
    of either package) and classifies the server into
    ok / dead / wedged: dead means the scrape cannot reach it at all; wedged
    means it answers but its `exchanges` counter has stopped advancing for
    `wedge_scrapes` consecutive scrapes while work is queued — alive to TCP,
    useless to training. Both verdicts trigger the injected `restart_fn`
    under a shared `RestartBudget`, so a crash-looping server exhausts the
    budget instead of restarting forever.

All three are deterministic under injected clocks/scrape functions; the
port's netchaos tests (`tests/test_torch_netchaos.py`) exercise the wired-up
whole through `service.netchaos.ChaosProxy`.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Optional

from repro_torch.obs import current_tracker
from repro_torch.runtime.fault_tolerance import RestartBudget

#: ladder rung names, by level index (the executor maps these to lanes)
LADDER_LEVELS = ("remote", "local", "ledger")


class LaneHealth:
    """Rolling-window error-rate + RTT + silence tracking for one lane."""

    def __init__(self, *, window: int = 16, error_threshold: float = 0.5,
                 min_samples: int = 4, stall_timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.window = window
        self.error_threshold = error_threshold
        self.min_samples = min_samples
        self.stall_timeout_s = stall_timeout_s
        self.clock = clock
        self._events: collections.deque = collections.deque(maxlen=window)
        #: submit timestamps of exchanges not yet answered (FIFO — the lanes
        #: are ordered depth-1 queues, so results come back in submit order)
        self._outstanding: collections.deque = collections.deque()
        self.successes = 0
        self.failures = 0

    def note_submit(self) -> None:
        self._outstanding.append(self.clock())

    def record(self, ok: bool, rtt_s: Optional[float] = None) -> None:
        """One exchange concluded: harvested gradient (ok) or lost (not ok)."""
        if self._outstanding:
            self._outstanding.popleft()
        self._events.append((bool(ok), rtt_s))
        if ok:
            self.successes += 1
        else:
            self.failures += 1

    def error_rate(self) -> float:
        if not self._events:
            return 0.0
        bad = sum(1 for ok, _ in self._events if not ok)
        return bad / len(self._events)

    def mean_rtt_s(self) -> float:
        rtts = [r for ok, r in self._events if ok and r is not None]
        return sum(rtts) / len(rtts) if rtts else 0.0

    def unhealthy(self) -> bool:
        """Enough recent samples and too many of them failures."""
        return (len(self._events) >= self.min_samples
                and self.error_rate() >= self.error_threshold)

    def stalled(self) -> bool:
        """An exchange is outstanding and the lane has been silent past the
        stall timeout — the blackhole signature (no errors, no results)."""
        if not self._outstanding:
            return False
        return self.clock() - self._outstanding[0] > self.stall_timeout_s

    def reset(self) -> None:
        """Fresh start (lane swap / reconnect): history from the previous
        lane must not condemn or absolve the new one."""
        self._events.clear()
        self._outstanding.clear()


class LaneLadder:
    """Degradation-ladder state machine: pure counters, no I/O.

    Levels run 0 (primary) .. n_levels-1 (deepest fallback). `tick()` once
    per executor step; `demote()` on an unhealthy/stalled verdict;
    `can_promote()` asks whether the cooldown has elapsed, and `promote()`
    moves one rung up and opens the probation window. A demotion inside
    probation doubles the next cooldown (capped), which is the hysteresis
    that prevents flapping against a half-dead upstream.
    """

    def __init__(self, n_levels: int = 3, *, probation_steps: int = 8,
                 cooldown_steps: int = 16, max_cooldown_steps: int = 256):
        assert n_levels >= 2
        self.n_levels = n_levels
        self.probation_steps = probation_steps
        self.base_cooldown = cooldown_steps
        self.max_cooldown = max_cooldown_steps
        self.level = 0
        self.failovers = 0       # cumulative demotions
        self.recoveries = 0      # cumulative promotions
        self._cooldown_cur = cooldown_steps   # next cooldown to impose
        self._cooldown_left = 0  # steps until promotion may be attempted
        self._probation_left = 0 # >0: recently promoted, demotion is costly

    def tick(self) -> None:
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
        if self._probation_left > 0:
            self._probation_left -= 1
            if self._probation_left == 0:
                # survived probation: the rung above is trustworthy again
                self._cooldown_cur = self.base_cooldown

    @property
    def in_probation(self) -> bool:
        return self._probation_left > 0

    def demote(self) -> bool:
        """One rung down; returns False when already at the bottom."""
        if self.level >= self.n_levels - 1:
            return False
        if self.in_probation:
            # the rung we just returned to failed again: back off harder
            self._cooldown_cur = min(self.max_cooldown,
                                     self._cooldown_cur * 2)
            self._probation_left = 0
        self.level += 1
        self.failovers += 1
        self._cooldown_left = self._cooldown_cur
        return True

    def can_promote(self) -> bool:
        return self.level > 0 and self._cooldown_left == 0

    def promote(self) -> bool:
        """One rung up (callers gate on `can_promote()` plus lane readiness);
        opens the probation window."""
        if not self.can_promote():
            return False
        self.level -= 1
        self.recoveries += 1
        self._probation_left = self.probation_steps
        return True


class ServerWatchdog:
    """STATS-scraping watchdog: tells a wedged ascent pool from a dead one.

    `check()` performs one scrape + classification and acts on the verdict;
    `start()` runs it on a daemon thread every `interval_s`. Restarts go
    through `restart_fn()` under the shared `RestartBudget` — past the
    budget the watchdog stops restarting (and says so once) but keeps
    classifying, so telemetry still shows what the server is doing.
    """

    def __init__(self, addr_fn: Callable[[], str],
                 restart_fn: Callable[[str], None],
                 budget: RestartBudget, *,
                 interval_s: float = 5.0, wedge_scrapes: int = 3,
                 scrape_timeout_s: float = 10.0, auth_token: str = "",
                 stats_fn: Optional[Callable[[str], dict]] = None):
        self._addr_fn = addr_fn
        self._restart_fn = restart_fn
        self.budget = budget
        self.interval_s = interval_s
        self.wedge_scrapes = wedge_scrapes
        if stats_fn is None:
            from repro_torch.service.client import fetch_pool_stats
            stats_fn = lambda addr: fetch_pool_stats(  # noqa: E731
                addr, auth_token=auth_token, timeout=scrape_timeout_s)
        self._stats_fn = stats_fn
        self._last_exchanges: Optional[int] = None
        self._frozen_scrapes = 0
        self._budget_spent_notice = False
        self.restarts = 0
        self.last_state = "ok"
        self.states: list = []      # classification history, for tests/ops
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- classification --------------------------------------------------------
    def classify(self) -> str:
        """One scrape -> "ok" | "dead" | "wedged" (no side effects beyond
        the freeze counter)."""
        try:
            snap = self._stats_fn(self._addr_fn())
        except Exception:  # noqa: BLE001 — unreachable/refusing/garbled alike
            self._last_exchanges = None
            self._frozen_scrapes = 0
            return "dead"
        exchanges = int(snap.get("exchanges", 0))
        depth = int(snap.get("queue_depth", 0))
        if (self._last_exchanges is not None
                and exchanges == self._last_exchanges and depth > 0):
            self._frozen_scrapes += 1
        else:
            self._frozen_scrapes = 0
        self._last_exchanges = exchanges
        if self._frozen_scrapes >= self.wedge_scrapes:
            return "wedged"
        return "ok"

    def check(self) -> str:
        """Classify and act: dead/wedged spend one restart and call
        `restart_fn(verdict)`."""
        verdict = self.classify()
        self.last_state = verdict
        self.states.append(verdict)
        if verdict == "ok":
            return verdict
        current_tracker().event("server_" + verdict, lane="watchdog",
                               restarts=self.restarts)
        try:
            self.budget.spend()
        except RuntimeError:
            if not self._budget_spent_notice:
                self._budget_spent_notice = True
                import sys
                print(f"[watchdog] server {verdict} but restart budget "
                      "exhausted; leaving it to the degradation ladder",
                      file=sys.stderr, flush=True)
            return verdict
        self.restarts += 1
        self._frozen_scrapes = 0
        self._last_exchanges = None
        self._restart_fn(verdict)
        return verdict

    # --- thread ----------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check()
            except Exception:  # noqa: BLE001 — the watchdog must outlive a
                pass           # failed restart attempt; next tick re-checks

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
