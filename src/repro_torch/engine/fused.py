"""FusedExecutor, Form A: one step function per training iteration
(counterpart of `repro.engine.fused`).

Meshless only. The port always runs the resident bucketed path: parameters,
optimizer moments and the ascent state are flat buffers updated in place
(`utils.buckets`), their kernels on the card and their plain versions on
the CPU, by the device of the parameters. The reference's other regimes
raise: a mesh (distributed, ROADMAP.md queue 1), `fused_update=False` and
`resident=False` (the per-leaf chain, slice 3 of the port).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core import Method, MethodConfig, TrainState, init_train_state, make_method
from repro_torch.core.api import LossFn
from repro_torch.core.async_sam import AsyncSamState
from repro_torch.engine.api import ensure_metric_contract
from repro_torch.optim import GradientTransform

PER_LEAF = ("the per-leaf weight-space path is not ported yet: slice 3 of the port, "
            "ROADMAP.md queue 1")


class FusedExecutor:
    """Single-resource executor: the whole step runs on the params' device.

    Args:
      loss_fn: framework loss callback `(params, batch, gen) -> (loss, aux)`.
      method: a `MethodConfig` (name-dispatched) or an already-built `Method`.
      optimizer: a `GradientTransform` from `optim.sgd` / `optim.adamw`.
      fused_update, resident: the reference's switches; None and True run
        the port's one path, False raises.
    """

    name = "fused"

    def __init__(self, loss_fn: LossFn,
                 method: Union[Method, MethodConfig, None] = None,
                 optimizer: Optional[GradientTransform] = None, *,
                 fused_update: Optional[bool] = None,
                 resident: Optional[bool] = None):
        if optimizer is None:
            raise ValueError("FusedExecutor needs an optimizer")
        if fused_update is False or resident is False:
            raise NotImplementedError(f"fused_update=False / resident=False: {PER_LEAF}")
        if isinstance(method, Method):
            self.method = method
        else:
            self.method = make_method(dataclasses.replace(method or MethodConfig(),
                                                          fused_update=True))
        self.optimizer = optimizer
        self.fused_update = self.resident = True
        self._step = self.method.make_step(loss_fn, optimizer)
        self._closed = False

    def init_state(self, params, seed: int = 0) -> TrainState:
        """`params`: the model (its parameters become views into the state's
        buffers), a mapping of name -> tensor, or a BucketedState."""
        return init_train_state(params, self.optimizer, self.method, seed)

    def step(self, state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        if self._closed:
            raise RuntimeError("executor is closed")
        state, metrics = self._step(state, batch)
        if state.params.device.type == "cuda":
            # host-side timing and callbacks see the step's real latency (the
            # reference blocks on the new params)
            torch.cuda.synchronize(state.params.device)
        ms = state.method_state
        tau = ms.staleness if isinstance(ms, AsyncSamState) else 0
        return state, ensure_metric_contract(
            metrics, tau=tau, perturbed=0.0 if self.method.name == "sgd" else 1.0)

    def close(self) -> None:
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
