"""Optimizers, schedules and their state (counterpart of `repro.optim.base`).

The reference carries an optax-style per-leaf transform chain beside a
`FusedSpec` that the fused flat-buffer path executes. The port runs the
fused path only (`repro_torch.optim.fused.fused_apply`): `sgd` and `adamw`
build a `GradientTransform` whose `init` gives the same `opt_state` tuple
layout as the reference's chain (one entry per transform, in chain order),
and whose `fused_spec` says what to run. The per-leaf chain (update
functions, masked weight decay, hand-built chains) is slice 3 of the port
(ROADMAP.md, queue 1) and raises here.

Schedules map a step (an int32 device tensor, so the learning rate never
leaves the device) to an fp32 tensor on the same device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch

from repro_torch.utils import trees

Tree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]

PER_LEAF_CHAIN = ("the per-leaf optimizer chain (hand-built chains, masked weight decay) "
                  "is not ported yet: slice 3 of the port, ROADMAP.md queue 1")


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).float()


def constant_schedule(value: float) -> Schedule:
    return lambda step: torch.full_like(_f32(step), value)


def cosine_schedule(peak: float, total_steps: int, warmup_steps: int = 0,
                    final_fraction: float = 0.0) -> Schedule:
    """Linear warmup then cosine decay to `final_fraction * peak`."""

    def sched(step):
        step = _f32(step)
        warm = peak * step / max(1.0, warmup_steps)
        decay_steps = max(1.0, total_steps - warmup_steps)
        frac = torch.clamp((step - warmup_steps) / decay_steps, 0.0, 1.0)
        cos = final_fraction + (1.0 - final_fraction) * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, peak * cos)

    return sched


def step_decay_schedule(peak: float, boundaries: Sequence[int],
                        factor: float = 0.1) -> Schedule:
    """Piecewise-constant decay (the paper's CIFAR recipes use this shape)."""

    def sched(step):
        step = _f32(step)
        bounds = torch.tensor(list(boundaries), dtype=torch.float32, device=step.device)
        n = torch.sum(step >= bounds).float()
        return peak * torch.pow(torch.full_like(step, factor), n)

    return sched


def as_schedule(lr) -> Schedule:
    return lr if callable(lr) else constant_schedule(float(lr))


# ---------------------------------------------------------------------------
# Transform states (the reference's NamedTuples, same fields)
# ---------------------------------------------------------------------------

class ScaleByScheduleState(NamedTuple):
    step: torch.Tensor


class TraceState(NamedTuple):
    momentum: Tree


class AdamState(NamedTuple):
    step: torch.Tensor
    mu: Tree
    nu: Tree


class ClipState(NamedTuple):
    last_norm: torch.Tensor


def _device(params) -> torch.device:
    return trees.tree_leaves(params)[0].device


def _zero(params, dtype) -> torch.Tensor:
    return torch.zeros((), dtype=dtype, device=_device(params))


def _clip_init(params) -> ClipState:
    return ClipState(last_norm=_zero(params, torch.float32))


def _adam_init(params) -> AdamState:
    return AdamState(step=_zero(params, torch.int32),
                     mu=trees.tree_zeros_like(params, torch.float32),
                     nu=trees.tree_zeros_like(params, torch.float32))


def _trace_init(params) -> TraceState:
    return TraceState(momentum=trees.tree_zeros_like(params, torch.float32))


def _decay_init(params) -> tuple:
    return ()


def _lr_init(params) -> ScaleByScheduleState:
    return ScaleByScheduleState(step=_zero(params, torch.int32))


# ---------------------------------------------------------------------------
# User-facing optimizers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FusedSpec:
    """What `optim.fused.fused_apply` runs: the canonical sgd/adamw chain, in
    the reference's transform order and state tuple layout."""
    family: str                       # "sgd" | "adamw"
    lr: Schedule
    clip_norm: Optional[float] = None
    weight_decay: float = 0.0
    momentum: float = 0.0
    nesterov: bool = False
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


class GradientTransform(NamedTuple):
    init: Callable[[Tree], tuple]     # params -> opt_state tuple
    fused_spec: Optional[FusedSpec] = None


def _chain(inits, spec: FusedSpec) -> GradientTransform:
    return GradientTransform(init=lambda params: tuple(f(params) for f in inits),
                             fused_spec=spec)


def sgd(lr, momentum: float = 0.0, nesterov: bool = False,
        weight_decay: float = 0.0, clip_norm: Optional[float] = None) -> GradientTransform:
    """The reference's sgd chain. Its epilogue kernel (`sgd_epilogue`) is not
    ported yet, so `fused_apply` raises for it (ROADMAP.md queue 2, item 6)."""
    inits = []
    if clip_norm is not None:
        inits.append(_clip_init)
    if weight_decay:
        inits.append(_decay_init)
    if momentum:
        inits.append(_trace_init)
    inits.append(_lr_init)
    return _chain(inits, FusedSpec(family="sgd", lr=as_schedule(lr), clip_norm=clip_norm,
                                   weight_decay=weight_decay, momentum=momentum,
                                   nesterov=nesterov))


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01, clip_norm: Optional[float] = None,
          decay_mask: Optional[Callable[[str], bool]] = None) -> GradientTransform:
    if decay_mask is not None:
        # a decay mask selects leaves by path, which the flat-buffer kernel
        # does not model: the reference keeps such chains on the per-leaf path
        raise NotImplementedError(f"adamw(decay_mask=...): {PER_LEAF_CHAIN}")
    inits = []
    if clip_norm is not None:
        inits.append(_clip_init)
    inits.append(_adam_init)
    if weight_decay:
        inits.append(_decay_init)
    inits.append(_lr_init)
    return _chain(inits, FusedSpec(family="adamw", lr=as_schedule(lr), clip_norm=clip_norm,
                                   weight_decay=weight_decay, b1=b1, b2=b2, eps=eps))


def make_optimizer(name: str, lr, **kw) -> GradientTransform:
    name = name.lower()
    if name == "sgd":
        return sgd(lr, **kw)
    if name == "adamw":
        return adamw(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
