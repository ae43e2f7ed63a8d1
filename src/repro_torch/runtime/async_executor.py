"""Heterogeneous asynchronous executor, the paper's two-lane scheme (Form B)
(counterpart of `repro.runtime.async_executor`).

* The DESCENT lane (the fast resource) runs `descent_fn`: one model update
  per step, perturbing with whatever ascent gradient is currently held.
* The ASCENT lane (the slow resource) runs `ascent_fn` on b' samples against
  a *snapshot* of the parameters, by construction one step old when consumed:
  tau = 1 (Algorithm 1).
* If the ascent lane has not delivered when the descent lane needs it, the
  held gradient is reused and its age grows (tau = 2, 3, ...) up to
  `max_staleness`, after which the step degrades to plain SGD: a straggling
  helper can slow convergence but never stall training.
* `calibrate()` measures per-sample gradient times on both lanes and returns
  the system-aware b' = (T_f / T_s) * b of paper §3.3.

The ascent lane is pluggable: `ThreadAscentLane` runs on a dedicated host
thread (on an H100 host: the descent lane on `cuda`, the ascent lane on the
CPU with `ascent_device="cpu"`, or on the card beside it);
`service.RemoteAscentClient` satisfies the same protocol over a socket,
moving the ascent lane to another process or host (`engine.RemoteExecutor`).
Both share `ascent_exchange`, the one function that owns the ascent-side
math (gradient, compression with error feedback, norm, wire bytes, the host
hand-off), so the in-process worker and `service.ascent_server` compute the
same exchanges.

The hand-off between the lanes is the reference's: the parameters leave the
descent lane as the reference's nested tree of host arrays
(`utils.buckets.host_portable`: one copy per dtype bucket, taken before the
next descent writes the buckets in place), and the gradient comes back in
that form. A lane that encodes its own jobs (the remote client) gets the live
device parameters instead and encodes them synchronously, before the next
descent.

Not ported here: the reference's degradation ladder and lane health
(`runtime/health.py`, with the watchdog), the numerics guard's executor hook
(`guard_update`), and the tracker's spans. Their `ExecutorConfig` fields stay
at their defaults; setting one raises, naming its ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
import warnings
from typing import Any, Callable, Optional, Protocol, Union, runtime_checkable

import numpy as np
import torch

from repro_torch.core import (Compressor, MethodConfig, StalenessLedger, TrainState,
                              make_ascent_fn, make_descent_fn, slice_ascent_batch, split_batch,
                              system_aware_ascent_fraction)
from repro_torch.core.api import LossFn, key_generator, lane_key, params_device
from repro_torch.core.ascent import CompressionState
from repro_torch.models import convert
from repro_torch.optim import GradientTransform, configure_fused
from repro_torch.utils import buckets, trees

Tree = Any
Device = Union[str, torch.device, None]

_HEALTH = "ROADMAP.md queue 1: runtime/health.py (lane ladder, health, watchdog)"
_NOT_PORTED = {
    "guard_update": "ROADMAP.md queue 1: runtime/guard.py (the numerics guard)",
    "lane_ladder": _HEALTH, "health_window": _HEALTH, "health_error_threshold": _HEALTH,
    "health_min_samples": _HEALTH, "health_stall_timeout_s": _HEALTH,
    "ladder_probation_steps": _HEALTH, "ladder_cooldown_steps": _HEALTH,
    "watchdog": _HEALTH, "watchdog_interval_s": _HEALTH, "watchdog_wedge_scrapes": _HEALTH,
    "watchdog_max_restarts": _HEALTH,
}


@dataclasses.dataclass
class ExecutorConfig:
    max_staleness: int = 4
    ascent_device: Device = None    # the "slow" resource; None: the descent's
    descent_device: Device = None   # the "fast" resource; None: where params are
    ascent_delay_s: float = 0.0     # test hook: straggler injection
    # flat-buffer fused perturb + optimizer epilogue on the descent lane;
    # None: on (the kernels on the card, their plain versions on the CPU)
    fused_update: Optional[bool] = None
    # bucket-resident descent-lane state; None follows fused_update when the
    # chain qualifies (lossless exchange + an optimizer with a FusedSpec)
    resident: Optional[bool] = None
    # deterministic test mode: block for every submitted ascent result
    # before the next harvest, so the tau schedule is timing-independent
    # (step 0 unperturbed, tau = 1 thereafter)
    lockstep: bool = False
    guard_update: Optional[bool] = None          # not ported (raises)
    # --- remote lane (engine.RemoteExecutor / repro_torch.service) -----------
    ascent_addr: str = ""          # "host:port" or "unix:/path" of the server
    serve_ascent: bool = False     # loopback: spawn the server as a subprocess
    loss_spec: str = ""            # server-side loss ("module:attr" | "arch:NAME[:reduced]")
    connect_timeout_s: float = 60.0
    reconnect_backoff_s: float = 0.25
    max_server_respawns: int = 1   # loopback only: respawn a server that died
    # JOB-direction encoding: "none" ships full fp32 snapshots; "int8"/"topk"
    # + job_delta delta-encode against the server's shadow (service.delta)
    job_compress: str = "none"
    job_delta: bool = True
    # --- multi-client pool (service.pool.AscentPool) ---------------------------
    client_id: str = ""
    sync_group: str = ""
    auth_token: str = ""
    pool_workers: int = 0          # loopback spawn only: 0 = server default
    # --- not ported: degradation ladder, lane health, server watchdog ---------
    lane_ladder: bool = False
    health_window: int = 16
    health_error_threshold: float = 0.5
    health_min_samples: int = 4
    health_stall_timeout_s: float = 30.0
    ladder_probation_steps: int = 8
    ladder_cooldown_steps: int = 16
    watchdog: bool = False
    watchdog_interval_s: float = 5.0
    watchdog_wedge_scrapes: int = 3
    watchdog_max_restarts: int = 2

    def __post_init__(self):
        for f in dataclasses.fields(self):
            if f.name in _NOT_PORTED and getattr(self, f.name) != f.default:
                raise NotImplementedError(
                    f"ExecutorConfig.{f.name} is not ported yet: {_NOT_PORTED[f.name]}")


# ---------------------------------------------------------------------------
# Shared ascent-worker math (in-process lane AND service.ascent_server)
# ---------------------------------------------------------------------------

def _leaf_tensor(x, device: Device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device) if device is not None else x
    a = np.asarray(x)
    bf16 = a.dtype.name == "bfloat16"
    if bf16:
        a = a.view(np.uint16)
    with warnings.catch_warnings():
        # a frame's leaves are read-only views of its bytes: nothing writes
        # them (the ascent takes no step), and a copy would cost the bytes
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(a)
    if bf16:
        t = t.view(torch.bfloat16)
    return t.to(device) if device is not None else t


def place_tree(tree: Tree, device: Device) -> Tree:
    """A nested tree of host arrays or tensors as tensors on `device` (None:
    tensors stay where they are, host arrays become CPU tensors)."""
    leaves, treedef = buckets.host_flatten(tree)
    return buckets.host_unflatten(treedef, [_leaf_tensor(x, device) for x in leaves])


def host_tree(tree: Tree) -> Tree:
    """A nested tree of tensors as numpy arrays the caller owns."""
    leaves, treedef = buckets.host_flatten(tree)
    return buckets.host_unflatten(
        treedef, [buckets.host_array(x) if isinstance(x, torch.Tensor) else x for x in leaves])


def tree_device(tree: Tree) -> torch.device:
    """The device of a tree's first tensor (the CPU for host arrays)."""
    leaves, _ = buckets.host_flatten(tree)
    return next((x.device for x in leaves if isinstance(x, torch.Tensor)), torch.device("cpu"))


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def ascent_exchange(ascent_fn: Callable, norm_fn: Callable, compressor: Compressor,
                    comp_state: Optional[CompressionState], params: Tree, batch: Tree, rng,
                    *, device: Device = None, delay_s: float = 0.0
                    ) -> tuple[Tree, float, int, Optional[CompressionState]]:
    """One ascent-lane exchange: gradient -> (lossy) hand-off value.

    Returns (host fp32 gradient tree, float norm, payload wire bytes, new
    compression state). `params` and `batch` are placed on `device` (None:
    the batch's device, i.e. the descent lane's, the counterpart of the
    reference's default device); `rng` is a uint32 key (`core.api.lane_key`
    or the reference's PRNG key data). Error feedback accumulates in
    `comp_state` on whichever side runs this (worker thread or server).
    """
    if delay_s:
        time.sleep(delay_s)  # injected straggle (tests/benchmarks)
    dev = torch.device(device) if device is not None else tree_device(batch)
    params = place_tree(params, dev)
    batch = place_tree(batch, dev)
    g, norm, _ = ascent_fn(params, batch, key_generator(rng, dev))
    if compressor.kind != "none":
        if comp_state is None:
            comp_state = compressor.init(g)
        g, comp_state = compressor.compress(g, comp_state)
        norm = float(norm_fn(g))
    else:
        norm = float(norm)
    wire = compressor.wire_bytes(g)
    return host_tree(g), norm, wire, comp_state    # the cross-resource hop


# ---------------------------------------------------------------------------
# Ascent-lane protocol + the default in-process thread lane
# ---------------------------------------------------------------------------

def poll_queue(q: queue.Queue, block: bool = False, timeout: Optional[float] = None):
    """Shared lane poll: non-raising get; None when nothing is ready."""
    try:
        if block:
            return q.get(timeout=timeout)
        return q.get_nowait()
    except queue.Empty:
        return None


def drain_queue(q: queue.Queue) -> None:
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass


@runtime_checkable
class AscentLane(Protocol):
    """Where the ascent gradient comes from (a thread, or another host).

    Results are (gen, grad_tree, norm, meta) tuples; `meta` carries
    lane-specific telemetry (ascent_time_s, wire_bytes, rtt_s) the executor
    forwards into its step metrics.
    """

    def full(self) -> bool: ...

    def submit(self, gen: int, params: Tree, batch: Tree, rng, step: int) -> bool: ...

    def poll(self, block: bool = False, timeout: Optional[float] = None
             ) -> Optional[tuple]: ...

    def reset(self) -> None: ...

    def close(self) -> None: ...


class ThreadAscentLane:
    """A dedicated worker thread + depth-1 job and result queues."""

    lane_name = "ascent-thread"

    def __init__(self, ascent_fn: Callable, norm_fn: Callable, compressor: Compressor, *,
                 device: Device = None, delay_s: float = 0.0):
        self._ascent_fn = ascent_fn
        self._norm_fn = norm_fn
        self._compressor = compressor
        self._comp_state = None
        self._device = device
        self._delay_s = delay_s
        self.wire_bytes_per_exchange = 0
        self.timings: list[float] = []
        self._jobs: queue.Queue = queue.Queue(maxsize=1)
        self._results: queue.Queue = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                gen, params, batch, rng, _step = self._jobs.get(timeout=0.1)
            except queue.Empty:
                continue
            if self._stop.is_set():   # shutting down: don't start new compute
                break
            t0 = time.perf_counter()
            g, norm, wire, self._comp_state = ascent_exchange(
                self._ascent_fn, self._norm_fn, self._compressor, self._comp_state,
                params, batch, rng, device=self._device, delay_s=self._delay_s)
            self.wire_bytes_per_exchange = wire
            dt = time.perf_counter() - t0
            self.timings.append(dt)
            try:
                self._results.put((gen, g, norm, {"ascent_time_s": dt}), timeout=1.0)
            except queue.Full:
                pass                 # consumer lagging: drop (stale anyway)

    def full(self) -> bool:
        return self._jobs.full()

    def submit(self, gen, params, batch, rng, step) -> bool:
        try:
            self._jobs.put_nowait((gen, params, batch, rng, step))
        except queue.Full:
            return False
        return True

    def poll(self, block: bool = False, timeout: Optional[float] = None):
        return poll_queue(self._results, block, timeout)

    def probe(self, params: Tree, batch: Tree, rng, probes: int) -> float:
        """Timed inline ascent runs (a warmup run excluded) for calibrate()."""
        dev = torch.device(self._device) if self._device is not None else tree_device(batch)
        p_in, b_in = place_tree(params, dev), place_tree(batch, dev)
        self._ascent_fn(p_in, b_in, key_generator(rng, dev))
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(probes):
            if self._delay_s:
                time.sleep(self._delay_s)
            self._ascent_fn(p_in, b_in, key_generator(rng, dev))
            synchronize(dev)
        return time.perf_counter() - t0

    def reset(self) -> None:
        drain_queue(self._jobs)
        drain_queue(self._results)

    def close(self) -> None:
        """Stop the worker: signal stop, drain both queues (a worker blocked
        in `results.put` must not wait out its timeout), then join, waiting
        out an ascent in flight."""
        self._stop.set()
        self.reset()
        if self._thread.is_alive():
            self._thread.join(timeout=30.0)


class LedgerOnlyLane:
    """No ascent source at all: `full()` is always True, so the executor
    never submits, and `poll()` never delivers. The held gradient ages on the
    staleness ledger and, past max_staleness, every step is plain SGD."""

    lane_name = "ascent-none"

    def full(self) -> bool:
        return True

    def submit(self, gen, params, batch, rng, step) -> bool:
        return False

    def poll(self, block: bool = False, timeout=None):
        return None

    def reset(self) -> None:
        pass

    def close(self) -> None:
        pass


class AsyncSamExecutor:
    def __init__(self, loss_fn: LossFn, method_cfg: MethodConfig,
                 optimizer: GradientTransform, exec_cfg: Optional[ExecutorConfig] = None,
                 ascent_lane: Optional[AscentLane] = None):
        self.xcfg = exec_cfg or ExecutorConfig()
        fused_update = self.xcfg.fused_update
        if fused_update is None:
            fused_update = True
        optimizer = configure_fused(optimizer, fused_update)
        method_cfg = dataclasses.replace(method_cfg, fused_update=fused_update)
        resident = self.xcfg.resident
        if resident is None:
            resident = (bool(fused_update) and method_cfg.compressor == "none"
                        and optimizer.fused_spec is not None)
        self.resident = bool(resident)
        self.cfg = method_cfg
        self.ledger = StalenessLedger(max_staleness=self.xcfg.max_staleness)
        # lossy compression of the cross-resource hand-off
        self._compressor = Compressor(kind=method_cfg.compressor,
                                      topk_fraction=method_cfg.topk_fraction)
        self._ascent_raw = make_ascent_fn(loss_fn)
        self._norm = trees.global_norm
        self._descent = make_descent_fn(method_cfg, loss_fn, optimizer)
        self._lane: AscentLane = ascent_lane if ascent_lane is not None else \
            ThreadAscentLane(self._ascent_raw, self._norm, self._compressor,
                             device=self.xcfg.ascent_device, delay_s=self.xcfg.ascent_delay_s)
        self._gen = 0            # bumped by reset(): fences off in-flight work
        self._inflight = 0       # results the lane still owes (lockstep gate)
        self._closed = False
        # the held perturbation direction (a host fp32 tree) and its norm
        self._held: Optional[tuple[Tree, float]] = None
        self._rho_scale = 1.0
        self.nonfinite_drops = 0
        self._exchange_meta: dict = {}
        self.timings = {"ascent": getattr(self._lane, "timings", []), "descent": []}
        self.last_calibration: Optional[dict] = None    # {t_fast, t_slow}, seconds/sample

    @property
    def wire_bytes_per_exchange(self) -> int:
        return getattr(self._lane, "wire_bytes_per_exchange", 0)

    # --- step ----------------------------------------------------------------
    def step(self, state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        descent_batch, ascent_batch = split_batch(batch)
        if ascent_batch is None:
            ascent_batch = slice_ascent_batch(descent_batch, self.cfg.ascent_fraction)

        # harvest a finished ascent gradient (fresh: tau resets to 1); results
        # from a pre-reset() generation are discarded
        block = self.xcfg.lockstep and self._inflight > 0
        got = self._lane.poll(block=block, timeout=120.0 if block else None)
        self._exchange_meta = {}
        if got is not None:
            self._inflight = max(0, self._inflight - 1)
            gen, g, norm, meta = got
            if g is not None and gen == self._gen and not np.isfinite(norm):
                # a non-finite harvest is a lost exchange: holding it would
                # poison every later perturbation (0 * NaN is NaN)
                self.nonfinite_drops += 1
                g = None
            if g is not None and gen == self._gen:
                self._held = (g, norm)
                self._exchange_meta = dict(meta)
                self.ledger.on_fresh()
                have = True
            else:
                # g None: the lane's lost-exchange sentinel; reuse and age
                have = self._held is not None and self.ledger.on_reuse()
        else:
            if block:
                # the blocking wait timed out: that exchange is lost
                self._inflight = max(0, self._inflight - 1)
            have = self._held is not None and self.ledger.on_reuse()

        # submit the next ascent job against the CURRENT params (one step old
        # when used, Algorithm 1 line 3); the full-check comes first so a busy
        # lane never costs the host copy. A lane that encodes its own jobs gets
        # the live device params and encodes them now, before the descent
        # below writes them in place; every other lane gets a host copy.
        if not self._lane.full():
            lane_params = (state.params if getattr(self._lane, "encodes_jobs", False)
                           else buckets.host_portable(state.params))
            if self._lane.submit(self._gen, lane_params, ascent_batch, lane_key(state),
                                 int(state.step)):
                self._inflight += 1

        t0 = time.perf_counter()
        g, norm = self._held if self._held is not None else (None, 0.0)
        # rho de-escalation: perturb computes rho/||a||, so feeding norm/scale
        # scales the effective rho by `scale`; scale 0 is plain descent
        scale = self._rho_scale
        if scale <= 0.0:
            have = False
        eff_norm = norm / scale if 0.0 < scale != 1.0 else norm
        new_state, metrics = self._descent(state, descent_batch, g, eff_norm, bool(have))
        synchronize(params_device(new_state.params))
        self.timings["descent"].append(time.perf_counter() - t0)
        metrics = dict(metrics)
        metrics["tau"] = self.ledger.tau
        metrics["perturbed"] = float(have)
        metrics["ascent_norm"] = float(norm)
        # remote-lane telemetry, only on the step that harvested an exchange
        for key in ("wire_bytes", "job_bytes", "grad_bytes", "rtt_s",
                    "pool_depth", "pool_wait_s", "client_id"):
            if key in self._exchange_meta:
                metrics[key] = float(self._exchange_meta[key])
        return new_state, metrics

    def reset(self) -> None:
        """Drop held and in-flight ascent state (after a checkpoint restore
        rolled the params back, or the remote lane reconnected): the next
        step perturbs only with a gradient computed against post-reset
        params. The generation fence keeps a result the lane is still
        computing from being consumed."""
        self._gen += 1
        self._inflight = 0
        self._lane.reset()
        self._held = None
        self.ledger.tau = 0

    def set_rho_scale(self, scale: float) -> None:
        """Scale the effective rho of every later step (1.0 undegraded, 0.0
        plain descent), at perturbation time: the held gradient is kept."""
        self._rho_scale = float(scale)

    def drop_ascent(self) -> None:
        """Discard the held ascent gradient without fencing the lane: an
        exchange in flight may still deliver a fresh replacement."""
        self._held = None
        self.ledger.tau = 0

    # --- system-aware b' (paper §3.3) ------------------------------------------
    def calibrate(self, state: TrainState, batch: dict, probes: int = 3) -> float:
        """Measure per-sample grad times on both lanes; return the suggested
        b'/b. The ascent probe goes through the lane (`probe`), so for a
        remote lane it measures server compute plus the wire."""
        descent_batch, ascent_batch = split_batch(batch)
        if ascent_batch is None:
            ascent_batch = descent_batch
        key = lane_key(state)
        elapsed = self._lane.probe(buckets.host_portable(state.params), ascent_batch, key,
                                   probes)
        n_asc = next(iter(ascent_batch.values())).shape[0]
        t_slow = elapsed / probes / n_asc

        # the descent lane's per-sample time (the ascent fn as the probe), on
        # views of the live params (the probe detaches them; nothing writes)
        dev = torch.device(self.xcfg.descent_device) if self.xcfg.descent_device else None
        views = (state.params.to_tree() if buckets.is_bucketed(state.params)
                 else dict(state.params))
        d_in = place_tree(convert.to_reference(views), dev)
        db_in = place_tree(descent_batch, dev)
        ddev = tree_device(d_in)
        self._ascent_raw(d_in, db_in, key_generator(key, ddev))
        synchronize(ddev)
        t0 = time.perf_counter()
        for _ in range(probes):
            self._ascent_raw(d_in, db_in, key_generator(key, ddev))
            synchronize(ddev)
        n_desc = next(iter(descent_batch.values())).shape[0]
        t_fast = (time.perf_counter() - t0) / probes / n_desc
        self.last_calibration = {"t_fast": t_fast, "t_slow": t_slow}
        return system_aware_ascent_fraction(t_fast, t_slow)

    def close(self) -> None:
        """Stop the ascent lane. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._lane.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
