"""ElasticExecutor: preemption-surviving, mesh-resizing training
(counterpart of `repro.engine.elastic`).

Wraps any inner executor (fused / hetero / remote) and re-enters the step
loop on a resized mesh when a device-loss or capacity event fires:

  * graceful shrink/grow ("resize" MeshEvents): the live state is re-placed
    onto the new mesh in-band, with no rollback and no lost steps. The fused
    executor re-places its state and rebuilds its step (`FusedExecutor.
    resize`); the hetero/remote family resets its ascent lane
    (`HeteroExecutor.resize`), which for a remote lane invalidates the
    client's `JobEncoder` shadow, so the next JOB resyncs through the
    snapshot path while the ascent pool keeps serving.
  * hard preemption ("crash" MeshEvents, or a real device failure raising
    out of the inner step): the step dies, `run_resilient` restores the last
    checkpoint, and this executor's `on_restore` re-places the restored
    state onto the survivor mesh before training resumes. Requires a
    `CheckpointCallback` on the Engine.

The global batch is preserved across resizes (the data pipeline is
mesh-agnostic; only the per-rank slice changes), so the loss trajectory of
a shrink->grow->shrink run tracks an uninterrupted one. Resizes are bounded
by a rolling-window budget (`resize_budget` events per `resize_window_s`;
lifetime when the window is None), the accounting `run_resilient` applies to
restarts.

Every rank of the world runs this loop with the same event schedule, so
every rank sees the same resizes at the same steps: a mesh is built on all
of them at once, a rank outside the current mesh still polls, keeps its step
count and rejoins on a grow, and the step's metrics are rank 0's on every
rank (`FusedExecutor.step`).

Telemetry: every step's metrics carry `mesh_devices` (current capacity); the
step right after a resize also carries `resize_events` (cumulative) and
`resize_time_s` (what the re-place cost). The tracker gets a `mesh_resize`
span per resize and `device_loss` / `restore_onto_survivors` events.
"""
from __future__ import annotations

import logging
import time
from typing import Optional

from repro_torch.core import TrainState
from repro_torch.obs import current_tracker, trace_now
from repro_torch.runtime.chaos import DeviceLoss, MeshEvent
from repro_torch.runtime.elastic import make_sized_mesh, reshard_state
from repro_torch.runtime.fault_tolerance import RestartBudget
from repro_torch.utils import distributed

log = logging.getLogger("repro_torch.elastic")


class ElasticExecutor:
    """Executor wrapper that survives mesh resizes mid-fit.

    Args:
      inner: the wrapped executor. If it implements
        `resize(state, new_mesh) -> state` (FusedExecutor, HeteroExecutor and
        its subclass do), resizes delegate to it; otherwise the generic path
        reshards via `runtime.elastic.reshard_state` (which needs
        `model_cfg`) and calls the inner `on_restore` hook if present.
      model_cfg: ModelConfig for the sharding rules; defaults to the inner
        executor's own.
      events: a MeshEvent source, anything with `poll(step) -> MeshEvent |
        None` (`runtime.chaos.ChaosSchedule`, or a capacity watcher). May be
        attached later via `attach_events` / `Engine.fit(events=...)`.
      model_axis: model-parallel axis size of meshes built for resize
        targets (devices must divide it).
      resize_budget / resize_window_s: rolling-window bound on resizes
        (lifetime when the window is None).
      meshless: force symbolic resizes (never build a mesh). Defaults to True
        exactly when the inner executor has no current mesh: the hetero and
        remote descent lanes are per-host, so a "resize" there re-syncs the
        lanes without re-placing.
    """

    name = "elastic"

    def __init__(self, inner, *, model_cfg=None, events=None,
                 model_axis: int = 1, resize_budget: int = 8,
                 resize_window_s: Optional[float] = None,
                 meshless: Optional[bool] = None):
        self.inner = inner
        self.model_cfg = (model_cfg if model_cfg is not None
                          else getattr(inner, "model_cfg", None))
        self.events = events
        self.model_axis = model_axis
        self._budget = RestartBudget(resize_budget, resize_window_s, what="resize")
        mesh = getattr(inner, "mesh", None)
        self.meshless = (mesh is None) if meshless is None else meshless
        self._device_type = mesh.device_type if mesh is not None else None
        self.devices = int(mesh.size) if mesh is not None else distributed.world_size()
        self.resize_events = 0
        self.last_resize_s = 0.0
        self._announce_resize = False
        self._pending: Optional[MeshEvent] = None

    # --- event plumbing -------------------------------------------------------
    def attach_events(self, events) -> None:
        """Plug in a MeshEvent source (Engine.fit(events=...) calls this)."""
        self.events = events

    @property
    def mesh(self):
        return getattr(self.inner, "mesh", None)

    def _resize(self, state: TrainState, event: MeshEvent) -> TrainState:
        try:
            new_mesh = None if self.meshless else make_sized_mesh(
                event.devices, self.model_axis, device=self._device_type)
        except ValueError as e:
            # unsatisfiable graceful resize (capacity vanished again, or a
            # target that never existed): keep training on the current mesh;
            # a healthy fit must not die, and no budget is spent
            log.warning("resize to %d device(s) at step %d skipped: %s",
                        event.devices, event.step, e)
            return state
        self._budget.spend()   # raises past the rolling-window budget
        t0 = time.perf_counter()
        resize = getattr(self.inner, "resize", None)
        if resize is not None:
            state = resize(state, new_mesh)
        else:
            if not self.meshless:
                if self.model_cfg is None:
                    raise ValueError(
                        "generic elastic resize needs model_cfg for the "
                        "sharding rules (or an inner executor implementing "
                        "resize(state, new_mesh))")
                state = reshard_state(state, self.model_cfg, new_mesh)
            hook = getattr(self.inner, "on_restore", None)
            if hook is not None:
                hook(state)
        self.devices = event.devices
        self.resize_events += 1
        self.last_resize_s = time.perf_counter() - t0
        current_tracker().span_at(
            "mesh_resize", lane="elastic", t0=trace_now() - self.last_resize_s,
            t1=trace_now(), step=event.step, devices=event.devices, kind=event.kind)
        self._announce_resize = True
        log.info("mesh resized at step %d -> %d device(s) in %.3fs (%s kind)",
                 event.step, event.devices, self.last_resize_s, event.kind)
        return state

    # --- the executor surface -------------------------------------------------
    def init_state(self, params, seed: int = 0) -> TrainState:
        return self.inner.init_state(params, seed)

    @property
    def wants_pre_fit(self) -> bool:
        return getattr(self.inner, "wants_pre_fit", hasattr(self.inner, "pre_fit"))

    def pre_fit(self, state: TrainState, batch: dict) -> Optional[dict]:
        hook = getattr(self.inner, "pre_fit", None)
        return hook(state, batch) if hook is not None else None

    def step(self, state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        if self.events is not None:
            while (ev := self.events.poll(int(state.step))) is not None:
                if ev.kind == "crash":
                    # the step dies; run_resilient restores and our
                    # on_restore re-places onto the survivor mesh
                    self._pending = ev
                    current_tracker().event("device_loss", lane="elastic",
                                            step=ev.step, devices=ev.devices)
                    raise DeviceLoss(ev)
                state = self._resize(state, ev)
        state, metrics = self.inner.step(state, batch)
        metrics = dict(metrics)
        metrics["mesh_devices"] = float(self.devices)
        if self._announce_resize:
            metrics["resize_events"] = float(self.resize_events)
            metrics["resize_time_s"] = float(self.last_resize_s)
            self._announce_resize = False
        return state, metrics

    def on_restore(self, state: TrainState) -> Optional[TrainState]:
        """Rollback hook (run_resilient): reset the inner executor's lanes,
        then, if a device loss is pending, re-place the restored state onto
        the survivor mesh and hand it back for adoption."""
        hook = getattr(self.inner, "on_restore", None)
        if hook is not None:
            hook(state)
        if self._pending is not None:
            ev, self._pending = self._pending, None
            current_tracker().event("restore_onto_survivors", lane="elastic",
                                    step=ev.step, devices=ev.devices)
            return self._resize(state, ev)
        return None

    def close(self) -> None:
        self.inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
