"""Deterministic chaos harness: scripted device-loss / capacity schedules
(counterpart of `repro.runtime.chaos`, plain Python, the same logic).

`run_resilient`'s `failure_injector(step)` models one failure mode, a step
that dies. Preemptible fleets have two more: devices that *vanish* (the step
dies AND the survivors are a smaller mesh) and capacity that *arrives* (the
mesh can grow back). `ChaosSchedule` scripts all three as `MeshEvent`s keyed
on the training step, so a chaos run is exactly reproducible:

    schedule = ChaosSchedule([
        MeshEvent(step=40, devices=4),                  # graceful shrink
        MeshEvent(step=80, devices=8),                  # capacity returns
        MeshEvent(step=120, devices=2, kind="crash"),   # hard preemption
    ])

Two consumption surfaces:

  * `poll(step)`: the `MeshEvent` source `engine.ElasticExecutor` drains
    before each inner step ("resize" reshards in-band; "crash" is raised as
    `DeviceLoss`).
  * `__call__(step)`: failure-injector compatibility. A schedule passed to a
    non-elastic run (`Engine.fit(failure_injector=schedule)` with a
    `CheckpointCallback`) raises its crash events as `DeviceLoss` (an
    `InjectedFailure`) and skips resizes.

Each event fires exactly once (wall-time semantics: a preemption happens
once, not once per replayed logical step after a rollback).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

from repro_torch.runtime.fault_tolerance import InjectedFailure

KINDS = ("resize", "crash")


@dataclasses.dataclass(frozen=True)
class MeshEvent:
    """One scripted capacity change, firing when the fit reaches `step`.

    devices: target device count after the event (shrink when below the
        current mesh, grow when above — the schedule does not care which).
    kind: "resize" = graceful (reshard live state in-band, no rollback);
          "crash" = hard device loss (the step dies; recovery restores the
          last checkpoint onto the shrunken mesh).
    """
    step: int
    devices: int
    kind: str = "resize"

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"MeshEvent.kind must be one of {KINDS}, "
                             f"got {self.kind!r}")
        if self.devices < 1:
            raise ValueError(f"MeshEvent.devices must be >= 1, "
                             f"got {self.devices}")


class DeviceLoss(InjectedFailure):
    """A crash-kind MeshEvent fired: the step dies and the mesh shrinks."""

    def __init__(self, event: MeshEvent):
        super().__init__(f"device loss at step {event.step}: "
                         f"mesh shrinks to {event.devices} device(s)")
        self.event = event


class ChaosSchedule:
    """Scripted, fire-once MeshEvent source (see module doc)."""

    def __init__(self, events: Iterable[MeshEvent]):
        self._events = sorted(events, key=lambda e: e.step)
        self._cursor = 0

    @property
    def pending(self) -> tuple[MeshEvent, ...]:
        """Events not yet fired, in firing order."""
        return tuple(self._events[self._cursor:])

    def poll(self, step: int) -> Optional[MeshEvent]:
        """Next unfired event with `event.step <= step`, else None."""
        if self._cursor < len(self._events) \
                and self._events[self._cursor].step <= step:
            ev = self._events[self._cursor]
            self._cursor += 1
            return ev
        return None

    def __call__(self, step: int) -> None:
        """Failure-injector surface: crash events raise, resizes are skipped
        (a non-elastic loop has no way to act on them)."""
        while True:
            if self._cursor >= len(self._events) \
                    or self._events[self._cursor].step > step:
                return
            ev = self._events[self._cursor]
            self._cursor += 1
            if ev.kind == "crash":
                raise DeviceLoss(ev)


def parse_schedule(spec: str) -> ChaosSchedule:
    """Parse a launcher-friendly schedule string.

    Comma-separated events, each `STEP:DEVICES[:crash]`:

        "40:4,80:8,120:2:crash"

    shrinks to 4 devices at step 40, grows to 8 at step 80, and hard-kills
    down to 2 at step 120.
    """
    events = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        parts = item.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(f"chaos event {item!r}: expected "
                             "STEP:DEVICES[:crash]")
        kind = "resize"
        if len(parts) == 3:
            kind = parts[2].strip()
        events.append(MeshEvent(step=int(parts[0]), devices=int(parts[1]),
                                kind=kind))
    if not events:
        raise ValueError(f"empty chaos schedule: {spec!r}")
    return ChaosSchedule(events)
