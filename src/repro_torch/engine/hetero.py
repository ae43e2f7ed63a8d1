"""HeteroExecutor, Form B: the paper's two-lane heterogeneous schedule
(counterpart of `repro.engine.hetero`).

Wraps `runtime.AsyncSamExecutor` (the descent lane + a dedicated ascent
thread, a depth-1 queue, the staleness ledger) behind the executor surface
`Engine.fit` drives, and makes the system-aware calibration of paper §3.3 a
pre-fit hook: with `calibrate=True`, `pre_fit` measures per-sample gradient
times on both lanes, reports the suggested b'/b, and from then on caps the
ascent sub-batch the slow lane sees at the calibrated size.

Lane placement comes from `ExecutorConfig.{ascent,descent}_device`
(`--ascent-device` / `--descent-device` in the launcher): on an H100 host,
the descent lane on `cuda` and the ascent lane a CPU thread is the paper's
CPU-helper-plus-accelerator scheme.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.core import (MethodConfig, TrainState, init_train_state, make_method,
                              slice_ascent_batch, split_batch)
from repro_torch.core.api import LossFn
from repro_torch.optim import GradientTransform
from repro_torch.runtime.async_executor import AsyncSamExecutor, ExecutorConfig

Tree = Any


class HeteroExecutor:
    """Two-resource executor: ascent on the slow lane, descent on the fast one."""

    name = "hetero"

    def __init__(self, loss_fn: LossFn, method_cfg: Optional[MethodConfig] = None,
                 optimizer: Optional[GradientTransform] = None, *,
                 exec_cfg: Optional[ExecutorConfig] = None,
                 calibrate: bool = False, calibration_probes: int = 3,
                 ascent_lane=None):
        method_cfg = method_cfg or MethodConfig()
        if method_cfg.name != "async_sam":
            raise ValueError(f"the hetero lanes realize async_sam only, got {method_cfg.name!r}")
        if optimizer is None:
            raise ValueError("HeteroExecutor needs an optimizer")
        self.cfg = method_cfg
        self.calibrate = calibrate
        self.calibration_probes = calibration_probes
        self.calibrated_fraction: Optional[float] = None
        # ascent_lane swaps where the slow lane runs: None -> the in-process
        # thread lane; a `service.RemoteAscentClient` -> another host (the
        # whole difference between `hetero` and `remote`)
        self._inner = AsyncSamExecutor(loss_fn, method_cfg, optimizer, exec_cfg,
                                       ascent_lane=ascent_lane)
        self.optimizer = optimizer
        self.method = make_method(self._inner.cfg)   # init() only; steps run split

    @property
    def ledger(self):
        return self._inner.ledger

    @property
    def timings(self):
        return self._inner.timings

    @property
    def resident(self) -> bool:
        return self._inner.resident

    def init_state(self, params, seed: int = 0) -> TrainState:
        """`params`: the model, a mapping of name -> tensor, or a
        BucketedState; resident (the inner executor's resolution), the
        model's parameters become views into the state's buffers."""
        return init_train_state(params, self.optimizer, self.method, seed,
                                resident=self._inner.resident)

    @property
    def wants_pre_fit(self) -> bool:
        """The Engine draws a probe batch only when calibration is enabled."""
        return self.calibrate

    def pre_fit(self, state: TrainState, batch: dict) -> Optional[dict]:
        """System-aware b' calibration (paper §3.3); runs before the fit loop."""
        if not self.calibrate:
            return None
        frac = self._inner.calibrate(state, batch, probes=self.calibration_probes)
        self.calibrated_fraction = frac
        return {"configured_ascent_fraction": self.cfg.ascent_fraction,
                "calibrated_ascent_fraction": frac, **self._inner.last_calibration}

    def _cap_ascent(self, batch: dict) -> dict:
        """Trim the ascent sub-batch to the calibrated b' (never grow it);
        a batch without an "ascent" key gets one sliced at the capped
        fraction."""
        if self.calibrated_fraction is None:
            return batch
        descent, ascent = split_batch(batch)
        if ascent is None:
            frac = min(self.cfg.ascent_fraction, self.calibrated_fraction)
            return {**descent, "ascent": slice_ascent_batch(descent, frac)}
        b = next(iter(descent.values())).shape[0]
        target = max(1, int(round(b * self.calibrated_fraction)))
        if next(iter(ascent.values())).shape[0] <= target:
            return batch
        return {**descent, "ascent": {k: v[:target] for k, v in ascent.items()}}

    def step(self, state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        return self._inner.step(state, self._cap_ascent(batch))

    def on_restore(self, state: TrainState) -> None:
        """Checkpoint rollback: drop held and in-flight ascent gradients,
        which were computed against params of the discarded timeline."""
        self._inner.reset()

    def set_rho_scale(self, scale: float) -> None:
        self._inner.set_rho_scale(scale)

    def drop_ascent(self) -> None:
        self._inner.drop_ascent()

    def resize(self, state: TrainState, new_mesh) -> TrainState:
        """Descent-mesh resize: the descent lane is meshless (per-host), so
        the state stays put, but the ascent lane must not keep serving
        gradients computed against the pre-resize timeline. `reset()` bumps
        the generation fence and resets the lane; a remote lane's client
        invalidates its `JobEncoder` shadow there, so the next JOB is a full
        snapshot under a fresh sync id and the ascent pool keeps serving
        across the resize (no server restart, no new wire format). The gap
        shows as tau growth on the staleness ledger and, past max_staleness,
        SGD fallback; training never stalls."""
        self._inner.reset()
        return state

    def close(self) -> None:
        self._inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
