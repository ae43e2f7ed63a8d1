"""Numerics guard: anomaly detection, the SAM de-escalation ladder, poison
rollback (counterpart of `repro.runtime.guard`, the same ladder logic).

The reference's guard protects the training dynamics: AsyncSAM applies
*stale* perturbations (paper §3), and staleness-amplified ascent steps are
where loss spikes and NaN/Inf gradients appear. The response mirrors the
lane ladder (runtime.health), one layer up the stack:

detection
    * on the device, in the step: `MethodConfig.guard_update` makes
      `core.api._finish` compute keep = isfinite(||g||) & isfinite(loss) on
      the device before the epilogue, and the epilogue kernels write nothing
      at keep 0 (the reference tree-selects the old state; the port's update
      is in place, so the verdict has to reach the kernels). The step emits
      `update_skipped` and `nonfinite_count` (one more pass over the
      gradient, paid only with the guard on);
    * on the host: a rolling median/MAD loss-spike detector (`SpikeDetector`)
      and a stale-ascent check that drops a held ascent gradient whose norm
      or tau exceeds bounds calibrated from the run's own history.

escalation ladder (`GuardedExecutor`, reusing `health.LaneLadder`)
    skip-step (in-step, state kept) -> SAM de-escalation (rho scaled down
    rung by rung until async_sam degrades to plain descent, with probation +
    cooldown-doubling) -> rollback.

diverge-proof rollback
    at the bottom rung with anomalies still firing, the step raises
    `fault_tolerance.PoisonBatch`: `run_resilient` restores the checkpoint
    but does NOT rewind the pipeline cursor, so the restarted run trains on
    fresh data instead of replaying the poison window.

`NumericChaos` is the injector giving the chaos harness a numerics
dimension (`--numchaos "nan_grad:nth=40,spike:prob=0.01"`). It is not
fire-once: poison is a property of the data, keyed on the pipeline cursor,
so a rollback that replays the stream re-poisons the same batches. It
poisons float tensors only; token batches have none, so on a language
model's pipeline it is a counted no-op.

The ladder reads the step's metrics on the host: `_classify` takes the
ones it needs in one device-to-host transfer per step.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import random
import statistics
from typing import Any, Iterator, Optional

import torch

from repro_torch.obs import current_tracker
from repro_torch.runtime.fault_tolerance import PoisonBatch
from repro_torch.runtime.health import LaneLadder

Tree = Any

#: the metrics `_classify` reads, fetched to the host in one transfer
_READ = ("update_skipped", "loss", "grad_norm", "ascent_reused", "ascent_norm",
         "ascent_loss", "tau")


@dataclasses.dataclass
class GuardConfig:
    """Knobs for detection, the de-escalation ladder, and rollback."""

    # --- loss-spike detector (rolling median/MAD, signed: only loss ABOVE
    # the median is anomalous, so a fast-improving loss never false-positives)
    spike_window: int = 32
    spike_zscore: float = 8.0
    spike_min_samples: int = 8
    # --- stale-ascent bounds (both calibrated/relative; 0 disables)
    stale_tau_max: int = 0          # drop the held gradient past this age
    stale_norm_mult: float = 10.0   # ... or past mult x rolling median norm
    stale_norm_window: int = 64
    stale_norm_min_samples: int = 16
    # --- ladder: one rho scale per rung; 0.0 = plain descent (bottom)
    rho_scales: tuple = (1.0, 0.5, 0.25, 0.0)
    demote_after: int = 2           # anomalies within anomaly_window
    anomaly_window: int = 8
    probation_steps: int = 16
    cooldown_steps: int = 16
    max_cooldown_steps: int = 256
    # --- rollback: PoisonBatch may only be raised when a checkpoint-restart
    # loop is there to catch it (run_resilient); without one the guard stays
    # at the bottom rung and keeps skipping — params stay finite either way
    rollback: bool = False


class SpikeDetector:
    """Rolling median/MAD loss-spike detector (host-side, O(window))."""

    def __init__(self, *, window: int = 32, min_samples: int = 8):
        self.min_samples = min_samples
        self._vals: collections.deque = collections.deque(maxlen=window)

    def score(self, x: float) -> Optional[float]:
        """Signed robust z-score of `x` against the window (None until the
        window holds `min_samples`). The 5%-of-median sigma floor keeps a
        dead-flat window (MAD 0) from flagging numeric jitter as a spike."""
        if len(self._vals) < self.min_samples:
            return None
        med = statistics.median(self._vals)
        mad = statistics.median(abs(v - med) for v in self._vals)
        sigma = 1.4826 * mad + 0.05 * abs(med) + 1e-8
        return (x - med) / sigma

    def observe(self, x: float) -> None:
        """Admit a NON-anomalous loss (spikes are kept out of the window so
        a spike train cannot teach the detector that spikes are normal)."""
        self._vals.append(x)

    def reset(self) -> None:
        self._vals.clear()


# ---------------------------------------------------------------------------
# NumericChaos — deterministic batch-poisoning injector
# ---------------------------------------------------------------------------

NUMCHAOS_KINDS = ("nan_grad", "inf_grad", "spike")


@dataclasses.dataclass(frozen=True)
class NumericRule:
    """One poisoning rule, a pure function of the data-stream index.

    kind: nan_grad (NaN-fill float leaves) | inf_grad (Inf-fill) |
          spike (scale float leaves by `scale` — a loss-spike batch).
    Selectors (any may combine): `nth` fires on indices [nth, nth+span);
    `every` fires on every multiple; `prob` fires pseudo-randomly but
    deterministically per index — replaying an index re-fires identically,
    because poison lives in the data, not in wall time.
    """
    kind: str
    nth: int = -1
    span: int = 1
    every: int = 0
    prob: float = 0.0
    scale: float = 1e4

    def __post_init__(self):
        if self.kind not in NUMCHAOS_KINDS:
            raise ValueError(f"numchaos kind must be one of {NUMCHAOS_KINDS}, "
                             f"got {self.kind!r}")


class NumericChaos:
    """Deterministic numerics-chaos schedule over a batch stream."""

    def __init__(self, rules, seed: int = 0):
        self.rules = list(rules)
        self.seed = seed
        self.fired: collections.Counter = collections.Counter()
        #: rules that matched a batch with no float leaves (token-only
        #: batches cannot carry NaN payloads — the injection is a no-op)
        self.skipped_no_float = 0

    def _fires(self, rule: NumericRule, ridx: int, idx: int) -> bool:
        if rule.nth >= 0 and rule.nth <= idx < rule.nth + rule.span:
            return True
        if rule.every > 0 and idx > 0 and idx % rule.every == 0:
            return True
        if rule.prob > 0.0:
            mixed = (self.seed * 1_000_003 + ridx) * 1_000_003 + idx
            return random.Random(mixed).random() < rule.prob
        return False

    def inject(self, idx: int, batch: Tree) -> Tree:
        for ridx, rule in enumerate(self.rules):
            if self._fires(rule, ridx, idx):
                batch, hit = _poison_batch(batch, rule)
                if hit:
                    self.fired[rule.kind] += 1
                else:
                    self.skipped_no_float += 1
        return batch


def _poison_batch(batch: Tree, rule: NumericRule) -> tuple[Tree, bool]:
    hit = False

    def fn(x):
        nonlocal hit
        if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
            return x
        hit = True
        if rule.kind == "nan_grad":
            return torch.full_like(x, float("nan"))
        if rule.kind == "inf_grad":
            return torch.full_like(x, float("inf"))
        return x * torch.tensor(rule.scale, dtype=x.dtype, device=x.device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return fn(t)

    return walk(batch), hit


def parse_numchaos(spec: str, seed: int = 0) -> NumericChaos:
    """Parse a launcher-friendly schedule, netchaos-grammar style.

    Comma-separated rules, each `kind[:key=val...]`:

        "nan_grad:nth=40,nan_grad:nth=60:span=8,spike:prob=0.01:scale=1e4"

    poisons batch 40, the whole window [60, 68), and ~1% of batches.
    """
    rules = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        parts = item.split(":")
        kw: dict = {}
        for p in parts[1:]:
            k, eq, v = p.partition("=")
            k = k.strip()
            if not eq:
                raise ValueError(f"numchaos rule {item!r}: expected key=val, "
                                 f"got {p!r}")
            if k in ("nth", "span", "every"):
                kw[k] = int(v)
            elif k in ("prob", "scale"):
                kw[k] = float(v)
            else:
                raise ValueError(f"numchaos rule {item!r}: unknown key {k!r}")
        rules.append(NumericRule(kind=parts[0].strip(), **kw))
    if not rules:
        raise ValueError(f"empty numchaos spec: {spec!r}")
    return NumericChaos(rules, seed=seed)


class NumericChaosPipeline:
    """Pipeline wrapper injecting NumericChaos per drawn batch.

    Carries its own cursor in `state()`/`restore()` (alongside the inner
    pipeline's) so a node-loss rollback replays the SAME poison — the
    injector is part of the data for restart-determinism purposes — while a
    `PoisonBatch` rollback, which skips the cursor restore entirely, runs
    past it.
    """

    def __init__(self, inner, chaos: NumericChaos):
        self.inner = inner
        self.chaos = chaos
        self._cursor = 0

    def state(self) -> dict:
        st = {"cursor": self._cursor}
        if hasattr(self.inner, "state"):
            st["inner"] = self.inner.state()
        return st

    def restore(self, state: dict) -> None:
        self._cursor = int(state["cursor"])
        if "inner" in state and hasattr(self.inner, "restore"):
            self.inner.restore(state["inner"])

    def peek(self) -> dict:
        """UNinjected: calibration probes must not calibrate on poison."""
        return self.inner.peek()

    def __iter__(self) -> Iterator[dict]:
        return self._gen(iter(self.inner))

    def _gen(self, it) -> Iterator[dict]:
        try:
            while True:
                try:
                    batch = next(it)
                except StopIteration:
                    return
                idx = self._cursor
                self._cursor += 1
                yield self.chaos.inject(idx, batch)
        finally:
            if hasattr(it, "close"):
                it.close()


# ---------------------------------------------------------------------------
# GuardedExecutor — the escalation ladder as a StepExecutor wrapper
# ---------------------------------------------------------------------------

class GuardedExecutor:
    """StepExecutor wrapper running the numerics-guard escalation ladder.

    Wraps any executor (fused / hetero / remote; outermost, so
    the verdict covers everything below). Per step it classifies the
    metrics the inner step emitted:

        skip            the in-step guard discarded the update
        nonfinite_state non-finite dynamics reached the host with the
                        update APPLIED (in-step guard off, or the params
                        were already poisoned) — the severe class
        spike           loss spiked past the rolling median/MAD band
        stale_ascent    the held ascent gradient aged or grew past bounds
                        (dropped via the executor's `drop_ascent` hook)

    and drives a `LaneLadder` over `GuardConfig.rho_scales`: each demotion
    scales rho one rung down (through the executor's `set_rho_scale` hook
    when the chain has one — the hetero/remote lanes — or by rescaling the
    fused form's carried `ascent_norm`, which changes the effective rho
    without touching the step function). The bottom rung is plain descent.
    Anomalies persisting there raise `PoisonBatch` (when `cfg.rollback`),
    handing the run to `run_resilient`'s diverge-proof rollback.

    The `ascent_loss` NaN-on-reuse sentinel of the fused async form is
    ignored whenever the step carries `ascent_reused=1` — the explicit flag
    that disambiguates it from a genuine NaN.
    """

    name = "guarded"

    def __init__(self, inner, cfg: Optional[GuardConfig] = None):
        self.inner = inner
        self.cfg = cfg or GuardConfig()
        assert len(self.cfg.rho_scales) >= 2, "need at least two rungs"
        assert self.cfg.rho_scales[0] == 1.0, "rung 0 is the undegraded state"
        self.ladder = LaneLadder(
            n_levels=len(self.cfg.rho_scales),
            probation_steps=self.cfg.probation_steps,
            cooldown_steps=self.cfg.cooldown_steps,
            max_cooldown_steps=self.cfg.max_cooldown_steps)
        self.spikes = SpikeDetector(window=self.cfg.spike_window,
                                    min_samples=self.cfg.spike_min_samples)
        self._norms: collections.deque = collections.deque(
            maxlen=self.cfg.stale_norm_window)
        self._anomalies: collections.deque = collections.deque(
            maxlen=self.cfg.anomaly_window)
        self.steps_skipped = 0
        self.poison_rollbacks = 0
        self._scale = 1.0
        self._pending_poison = False
        self._pending_drop = False
        self._announce = False
        self._rho_hook = self._find_hook("set_rho_scale")
        self._drop_hook = self._find_hook("drop_ascent")

    # --- hook resolution over the wrapper chain -----------------------------
    def _find_hook(self, name: str):
        """Walk inner/._inner wrappers (hetero -> executor) for a
        lane-level hook; None means the fused state-transform path."""
        obj, seen = self.inner, set()
        while obj is not None and id(obj) not in seen:
            seen.add(id(obj))
            fn = getattr(obj, name, None)
            if callable(fn):
                return fn
            obj = getattr(obj, "inner", None) or getattr(obj, "_inner", None)
        return None

    # --- rho scaling --------------------------------------------------------
    def _apply_scale(self) -> None:
        self._scale = float(self.cfg.rho_scales[self.ladder.level])
        if self._rho_hook is not None:
            self._rho_hook(self._scale)

    def _pre_step(self, state):
        """Fused Form A has no lane to hand the scale to — the carried
        AsyncSamState is where rho acts, so de-escalation rescales its norm
        (perturb computes rho/||a||: norm/scale <=> rho*scale) and the
        bottom rung clears have_ascent; the norm is recomputed from the
        gradient every refresh, so the rescale cannot compound. Dropping a
        stale gradient goes through the `drop_ascent` hook when the chain
        has one, else the same state transform."""
        ms = getattr(state, "method_state", None)
        from repro_torch.core.async_sam import AsyncSamState
        is_async = isinstance(ms, AsyncSamState)
        if self._pending_drop:
            self._pending_drop = False
            if self._drop_hook is not None:
                self._drop_hook()
            elif is_async:
                ms = ms._replace(have_ascent=False, staleness=0)
                state = state._replace(method_state=ms)
        if self._rho_hook is not None or not is_async:
            return state
        if self._scale <= 0.0:
            state = state._replace(method_state=ms._replace(have_ascent=False))
        elif self._scale != 1.0:
            state = state._replace(method_state=ms._replace(
                ascent_norm=ms.ascent_norm / self._scale))
        return state

    # --- classification -----------------------------------------------------
    @staticmethod
    def _host(metrics: dict) -> dict:
        """The metrics `_classify` reads, as host floats: the device scalars
        among them stacked and read in one transfer."""
        m = {k: metrics[k] for k in _READ if k in metrics}
        dev = [k for k, v in m.items() if isinstance(v, torch.Tensor)]
        if dev:
            where = m[dev[0]].device
            vals = torch.stack([m[k].detach().reshape(()).to(where, torch.float64)
                                for k in dev]).tolist()
            m.update(zip(dev, vals))
        return {k: float(v) for k, v in m.items()}

    def _classify(self, m: dict) -> set:
        m = self._host(m)
        kinds: set = set()
        if float(m.get("update_skipped", 0.0)) > 0.5:
            kinds.add("skip")
        # severe: non-finite loss/grad reached the host with the update
        # APPLIED — in-step guard off for this method, or the params were
        # already poisoned. A non-finite ASCENT side (loss or norm; the
        # ascent_loss NaN sentinel doesn't count when ascent_reused says so)
        # is NOT severe — the carried state is guarded/dropped and the params
        # are fine — it classifies as a stale-ascent drop instead.
        bad = any(k in m and not math.isfinite(float(m[k]))
                  for k in ("loss", "grad_norm"))
        if bad and "skip" not in kinds:
            kinds.add("nonfinite_state")
        reused = float(m.get("ascent_reused", 0.0)) > 0.5
        asc_watch = ["ascent_norm"] + ([] if reused else ["ascent_loss"])
        if any(k in m and not math.isfinite(float(m[k])) for k in asc_watch):
            kinds.add("stale_ascent")
        loss = m.get("loss")
        if loss is not None and math.isfinite(float(loss)):
            z = self.spikes.score(float(loss))
            if z is not None and z > self.cfg.spike_zscore:
                kinds.add("spike")
            else:
                self.spikes.observe(float(loss))
        if self.cfg.stale_tau_max and \
                float(m.get("tau", 0.0)) > self.cfg.stale_tau_max:
            kinds.add("stale_ascent")
        an = m.get("ascent_norm")
        if (an is not None and self.cfg.stale_norm_mult
                and math.isfinite(float(an)) and float(an) > 0.0):
            an = float(an)
            if (len(self._norms) >= self.cfg.stale_norm_min_samples
                    and an > self.cfg.stale_norm_mult
                    * statistics.median(self._norms)):
                kinds.add("stale_ascent")
            else:
                self._norms.append(an)
        return kinds

    # --- the ladder decision ------------------------------------------------
    def _act(self, kinds: set) -> None:
        trk = current_tracker()
        self.ladder.tick()
        if "skip" in kinds:
            self.steps_skipped += 1
            self._announce = True
            trk.event("guard_skip", lane="guard", skips=self.steps_skipped)
        if "stale_ascent" in kinds:
            self._pending_drop = True
            trk.event("guard_stale_drop", lane="guard")
        if "nonfinite_state" in kinds and self.cfg.rollback:
            # the params themselves are (or may be) non-finite: no rung of
            # the ladder can repair corrupted state — straight to rollback
            self._poison("non-finite training state reached the host")
        self._anomalies.append(bool(kinds))
        if kinds:
            if sum(self._anomalies) >= self.cfg.demote_after:
                self._anomalies.clear()   # the next verdict needs fresh evidence
                if self.ladder.demote():
                    self._apply_scale()
                    trk.event("guard_deescalate", lane="guard",
                              level=self.ladder.level, rho_scale=self._scale,
                              kinds=sorted(kinds))
                elif self.cfg.rollback:
                    self._poison("anomalies persist at the bottom rung "
                                 f"({sorted(kinds)})")
                # else: nothing left to de-escalate and no rollback target —
                # keep skipping; the in-step guard keeps the params finite
        elif self.ladder.can_promote() and not any(self._anomalies):
            self.ladder.promote()
            self._apply_scale()
            trk.event("guard_recovery", lane="guard",
                      level=self.ladder.level, rho_scale=self._scale)

    def _poison(self, why: str):
        self._pending_poison = True
        current_tracker().event("guard_poison", lane="guard",
                                level=self.ladder.level)
        raise PoisonBatch(f"numerics guard: {why}")

    # --- StepExecutor -------------------------------------------------------
    def step(self, state, batch):
        state = self._pre_step(state)
        state, metrics = self.inner.step(state, batch)
        metrics = dict(metrics)
        self._act(self._classify(metrics))   # may raise PoisonBatch
        # rung + scale every step (lane_state pattern); cumulative counters
        # only on the step at/after a transition, so summing a jsonl column
        # never double-counts (the resize_events emission pattern)
        metrics["guard_state"] = float(self.ladder.level)
        metrics["rho_scale"] = float(self._scale)
        if self._announce:
            self._announce = False
            metrics["steps_skipped"] = float(self.steps_skipped)
            metrics["poison_rollbacks"] = float(self.poison_rollbacks)
        return state, metrics

    def on_restore(self, state):
        """Rollback hook: chain the inner executor's (lane resets; a state
        it adopts is forwarded), account a pending
        poison rollback, and reset the detectors — the restored timeline's
        dynamics are not the failed one's. The ladder keeps its rung: the
        run re-enters still de-escalated and earns its way back up through
        the normal cooldown/probation path (= observable guard recoveries).
        """
        hook = getattr(self.inner, "on_restore", None)
        adopted = hook(state) if hook is not None else None
        if self._pending_poison:
            self._pending_poison = False
            self.poison_rollbacks += 1
            self._announce = True
            current_tracker().event("poison_rollback", lane="guard",
                                    rollbacks=self.poison_rollbacks)
        self.spikes.reset()
        self._norms.clear()
        self._anomalies.clear()
        return adopted

    def close(self) -> None:
        self.inner.close()

    def __getattr__(self, name: str):
        # everything else (init_state, pre_fit, wants_pre_fit, attach_events,
        # mesh, resize, calibrate ...) delegates to the wrapped executor
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
