"""FusedExecutor, Form A: one step function per training iteration
(counterpart of `repro.engine.fused`).

Meshless only (a mesh is the distributed slice, ROADMAP.md queue 1). Two
switches choose the weight-space path, resolved as the reference resolves
them:
* `fused_update`: the flat-buffer kernels (perturb, optimizer epilogue,
  ascent refresh). None takes the port's default, on for every device (the
  kernels on the card, their plain versions on the CPU); False runs the
  reference's per-leaf compositions and optimizer chain.
* `resident`: bucket-resident state (parameters, moments and the ascent
  state as flat buffers updated in place, `utils.buckets`). None follows the
  resolved `fused_update` when the whole chain qualifies: a RESIDENT_METHODS
  method with the lossless ascent exchange and an optimizer the fused path
  recognizes (`optim.sgd` / `optim.adamw` without a decay mask).
The default, and the path of the card, is fused and resident.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core import Method, MethodConfig, TrainState, init_train_state, make_method
from repro_torch.core.api import LossFn, params_device
from repro_torch.core.async_sam import AsyncSamState
from repro_torch.engine.api import ensure_metric_contract
from repro_torch.optim import GradientTransform, configure_fused

# Methods whose steps are weight-space + value_and_grad compositions, kept on
# bucket-resident state (the reference's list). The others (looksam, esam,
# aesam, mesa) keep per-leaf state, as in the reference; with fused_update on
# their weight-space passes still run the flat-buffer kernels, each call
# gathering its operands into buckets.
RESIDENT_METHODS = ("sgd", "sam", "gsam", "async_sam")


class FusedExecutor:
    """Single-resource executor: the whole step runs on the params' device.

    Args:
      loss_fn: framework loss callback `(params, batch, gen) -> (loss, aux)`.
      method: a `MethodConfig` (name-dispatched) or an already-built `Method`.
      optimizer: a `GradientTransform` (`optim.sgd`, `optim.adamw`, or a
        hand-built chain, which runs per-leaf).
      fused_update, resident: see the module docstring.
    """

    name = "fused"

    def __init__(self, loss_fn: LossFn,
                 method: Union[Method, MethodConfig, None] = None,
                 optimizer: Optional[GradientTransform] = None, *,
                 fused_update: Optional[bool] = None,
                 resident: Optional[bool] = None):
        if optimizer is None:
            raise ValueError("FusedExecutor needs an optimizer")
        if fused_update is None:
            fused_update = True
        optimizer = configure_fused(optimizer, fused_update)
        if isinstance(method, Method):
            # rebuild from its config so the step sees the resolved flag; a
            # hand-constructed Method without one is taken as it is
            if method.cfg is not None and method.cfg.fused_update != fused_update:
                method = make_method(dataclasses.replace(method.cfg, fused_update=fused_update))
            self.method = method
        else:
            self.method = make_method(dataclasses.replace(method or MethodConfig(),
                                                          fused_update=fused_update))
        if resident is None:
            mcfg = self.method.cfg
            resident = (fused_update and self.method.name in RESIDENT_METHODS
                        and optimizer.fused_spec is not None
                        and (mcfg is None or mcfg.compressor == "none"))
        if resident and optimizer.fused_spec is None:
            raise ValueError("bucket-resident state needs an optimizer the fused path "
                             "recognizes (optim.sgd / optim.adamw without a decay mask); "
                             "use resident=False")
        self.fused_update = bool(fused_update)
        self.resident = bool(resident)
        self.optimizer = optimizer
        self._step = self.method.make_step(loss_fn, optimizer)
        self._closed = False

    def init_state(self, params, seed: int = 0) -> TrainState:
        """`params`: the model, a mapping of name -> tensor, or a
        BucketedState. Resident, the model's parameters become views into the
        state's buffers; per-leaf, the state holds their tensors. Either way
        the model reads what the steps write."""
        return init_train_state(params, self.optimizer, self.method, seed,
                                resident=self.resident)

    def step(self, state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        if self._closed:
            raise RuntimeError("executor is closed")
        state, metrics = self._step(state, batch)
        dev = params_device(state.params)
        if dev.type == "cuda":
            # host-side timing and callbacks see the step's real latency (the
            # reference blocks on the new params)
            torch.cuda.synchronize(dev)
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
