"""Optimizers, schedules and their state (counterpart of `repro.optim.base`).

As in the reference, an optimizer is an optax-style `GradientTransform`: a
per-leaf `init`/`update` pair, composable with `chain`, plus the `FusedSpec`
that the canonical `sgd`/`adamw` factories attach so that
`repro_torch.optim.fused.fused_apply` can run the same chain as one epilogue
kernel per dtype bucket. Both paths consume and produce the same `opt_state`
tuple layout (one entry per transform, in chain order). The per-leaf path is
the oracle, the path of hand-built chains and of masked weight decay
(`adamw(decay_mask=...)`, which the flat-buffer kernels do not model), and
the path of `FusedExecutor(fused_update=False)`.

Updates are functional, as in the reference: `update` returns new trees and
`apply_updates` new parameters; the training step (`core.api._finish`)
writes them back into the state's tensors.

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
# Transforms (the reference's per-leaf chain, same state NamedTuples)
# ---------------------------------------------------------------------------

class GradientTransform(NamedTuple):
    init: Callable[[Tree], Tree]
    update: Callable[..., tuple[Tree, Tree]]  # (grads, state, params) -> (updates, state)
    # set by the canonical sgd()/adamw() factories, None for hand-built chains
    fused_spec: Optional["FusedSpec"] = None


def chain(*transforms: GradientTransform) -> GradientTransform:
    """Compose transforms left to right (optax.chain semantics)."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransform(init, update)


def identity() -> GradientTransform:
    return GradientTransform(lambda p: (), lambda g, s, p=None: (g, s))


def _device(params) -> torch.device:
    return trees.tree_leaves(params)[0].device


def _zero(params, dtype) -> torch.Tensor:
    return torch.zeros((), dtype=dtype, device=_device(params))


def _scale(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x * s with JAX's promotion of a leaf against a 0-d fp32 array (a bf16
    leaf times an fp32 scalar is fp32 there; PyTorch would keep bf16)."""
    return x.to(torch.promote_types(x.dtype, s.dtype)) * s


class ScaleByScheduleState(NamedTuple):
    step: torch.Tensor


def scale_by_learning_rate(lr) -> GradientTransform:
    sched = as_schedule(lr)

    def init(params):
        return ScaleByScheduleState(step=_zero(params, torch.int32))

    def update(grads, state, params=None):
        eta = sched(state.step)
        return (trees.tree_map(lambda g: _scale(g, -eta), grads),
                ScaleByScheduleState(step=state.step + 1))

    return GradientTransform(init, update)


class TraceState(NamedTuple):
    momentum: Tree


def trace(decay: float, nesterov: bool = False) -> GradientTransform:
    """Heavy-ball / Nesterov momentum."""

    def init(params):
        return TraceState(momentum=trees.tree_zeros_like(params, torch.float32))

    def update(grads, state, params=None):
        m = trees.tree_map(lambda mi, gi: decay * mi + gi.float(), state.momentum, grads)
        out = (trees.tree_map(lambda mi, gi: decay * mi + gi.float(), m, grads)
               if nesterov else m)
        out = trees.tree_map(lambda o, g: o.to(g.dtype), out, grads)
        return out, TraceState(momentum=m)

    return GradientTransform(init, update)


class AdamState(NamedTuple):
    step: torch.Tensor
    mu: Tree
    nu: Tree


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransform:
    def init(params):
        return AdamState(step=_zero(params, torch.int32),
                         mu=trees.tree_zeros_like(params, torch.float32),
                         nu=trees.tree_zeros_like(params, torch.float32))

    def update(grads, state, params=None):
        step = state.step + 1
        mu = trees.tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu, grads)
        nu = trees.tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                            state.nu, grads)
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()
        updates = trees.tree_map(
            lambda m, v, g: ((m / c1) / (torch.sqrt(v / c2) + eps)).to(g.dtype), mu, nu, grads)
        return updates, AdamState(step=step, mu=mu, nu=nu)

    return GradientTransform(init, update)


def add_decayed_weights(weight_decay: float,
                        mask_fn: Optional[Callable[[str], bool]] = None) -> GradientTransform:
    """Decoupled weight decay; `mask_fn(path)` selects the decayed leaves by
    their path in the reference's tree ("blocks/attn/wq": slash-joined, the
    port's block index dropped), so one mask serves both packages."""

    def init(params):
        return ()

    def update(grads, state, params=None):
        if weight_decay == 0.0 or params is None:
            return grads, state
        decay = lambda g, p: g + weight_decay * p.to(g.dtype)  # noqa: E731
        if mask_fn is None:
            return trees.tree_map(decay, grads, params), state
        paths = trees.tree_paths(grads)
        masked = dict(zip(paths, (mask_fn(p) for p in paths)))
        return trees.tree_map_with_path(
            lambda path, g, p: decay(g, p) if masked[path] else g, grads, params), state

    return GradientTransform(init, update)


class ClipState(NamedTuple):
    last_norm: torch.Tensor


def clip_by_global_norm(max_norm: float) -> GradientTransform:
    def init(params):
        return ClipState(last_norm=_zero(params, torch.float32))

    def update(grads, state, params=None):
        gnorm = trees.global_norm(grads)
        scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
        out = trees.tree_map(lambda g: _scale(g, scale).to(g.dtype), grads)
        return out, ClipState(last_norm=gnorm)

    return GradientTransform(init, update)


# ---------------------------------------------------------------------------
# User-facing optimizers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FusedSpec:
    """What `optim.fused.fused_apply` runs: the canonical sgd/adamw chain, in
    the reference's transform order and state tuple layout. `enabled=None`
    takes the port's default, the fused path on every device (the kernels on
    the card, their plain versions on the CPU); False keeps the per-leaf
    path (`optim.fused.configure`)."""
    family: str                       # "sgd" | "adamw"
    lr: Schedule
    clip_norm: Optional[float] = None
    weight_decay: float = 0.0
    momentum: float = 0.0
    nesterov: bool = False
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    enabled: Optional[bool] = None


def sgd(lr, momentum: float = 0.0, nesterov: bool = False,
        weight_decay: float = 0.0, clip_norm: Optional[float] = None) -> GradientTransform:
    """The reference's sgd chain: clip -> decay -> trace -> lr."""
    parts = []
    if clip_norm is not None:
        parts.append(clip_by_global_norm(clip_norm))
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay))
    if momentum:
        parts.append(trace(momentum, nesterov=nesterov))
    parts.append(scale_by_learning_rate(lr))
    spec = FusedSpec(family="sgd", lr=as_schedule(lr), clip_norm=clip_norm,
                     weight_decay=weight_decay, momentum=momentum, nesterov=nesterov)
    return chain(*parts)._replace(fused_spec=spec)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01, clip_norm: Optional[float] = None,
          decay_mask: Optional[Callable[[str], bool]] = None) -> GradientTransform:
    """The reference's adamw chain: clip -> adam -> decay -> lr. A decay mask
    selects leaves by path, which the flat-buffer kernel does not model: such
    a chain has no FusedSpec and keeps the per-leaf path."""
    parts = []
    if clip_norm is not None:
        parts.append(clip_by_global_norm(clip_norm))
    parts.append(scale_by_adam(b1, b2, eps))
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay, decay_mask))
    parts.append(scale_by_learning_rate(lr))
    spec = None if decay_mask is not None else FusedSpec(
        family="adamw", lr=as_schedule(lr), clip_norm=clip_norm, weight_decay=weight_decay,
        b1=b1, b2=b2, eps=eps)
    return chain(*parts)._replace(fused_spec=spec)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return trees.tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype), params, updates)


def make_optimizer(name: str, lr, **kw) -> GradientTransform:
    name = name.lower()
    if name == "sgd":
        return sgd(lr, **kw)
    if name == "adamw":
        return adamw(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
