"""Step builders: the train step of the SAM family and the serve steps
(prefill/decode) (counterpart of `repro.launch.steps`).

As in the reference this is a thin shim: training goes through
`repro_torch.engine` (`FusedExecutor` / `HeteroExecutor` + `Engine.fit`),
which owns the mesh, the placement of the state and the step's buffers;
`TrainSetup.fused_executor` bridges to it. The serve steps call the bundle's
prefill and decode.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.core import Method, MethodConfig, TrainState, init_train_state, make_method
from repro_torch.models.registry import ModelBundle
from repro_torch.optim import GradientTransform, make_optimizer

Tree = Any


@dataclasses.dataclass(frozen=True)
class TrainSetup:
    bundle: ModelBundle
    method: Method
    method_cfg: MethodConfig
    optimizer: GradientTransform
    step_fn: Callable[[TrainState, dict], tuple[TrainState, dict]]

    def init_state(self, params, seed: int = 0) -> TrainState:
        """The step-0 state (`core.init_train_state`: bucket-resident when
        the optimizer has a FusedSpec, else per-leaf)."""
        return init_train_state(params, self.optimizer, self.method, seed,
                                resident=self.optimizer.fused_spec is not None)

    def fused_executor(self, *, mesh=None, model_cfg=None):
        """Bridge to the Engine API: the same pieces as an executor."""
        from repro_torch.engine import FusedExecutor
        return FusedExecutor(self.bundle.loss_fn, self.method, self.optimizer,
                             mesh=mesh, model_cfg=model_cfg)


def make_train_setup(bundle: ModelBundle,
                     method_cfg: Optional[MethodConfig] = None,
                     optimizer: Optional[GradientTransform] = None,
                     lr: float = 1e-3) -> TrainSetup:
    method_cfg = method_cfg or MethodConfig()
    method = make_method(method_cfg)
    optimizer = optimizer or make_optimizer("adamw", lr)
    step_fn = method.make_step(bundle.loss_fn, optimizer)
    return TrainSetup(bundle=bundle, method=method, method_cfg=method_cfg,
                      optimizer=optimizer, step_fn=step_fn)


def make_prefill_step(bundle: ModelBundle) -> Callable:
    def prefill_step(params, batch: dict):
        return bundle.prefill(params, batch)

    return prefill_step


def make_decode_step(bundle: ModelBundle) -> Callable:
    def decode_step(params, cache, batch: dict):
        return bundle.decode(params, cache, batch)

    return decode_step
