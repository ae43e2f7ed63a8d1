"""Training-method API: a uniform step interface over the SAM family
(counterpart of `repro.core.api`).

Every method is exposed as a `Method` with

    init(params, seed)                 -> method_state
    make_step(loss_fn, optimizer)      -> step(state, batch) -> (state, metrics)

where `state` is the framework-wide `TrainState`. The loss callback protocol
is

    loss_fn(params, batch, gen) -> (scalar_loss, aux_dict)

with `params` a mapping of leaf name -> tensor and `gen` a torch.Generator.

What differs from the reference, and why:
* State is bucket-resident (`utils.buckets.BucketedState`) and updated in
  place: the counterpart of the reference's donated jit buffers. Each step
  writes into buffers it reuses (`Workspace`).
* Gradients land in a flat gradient buffer with no gather: the loss sees leaf
  views of the w (or w_hat) buffer that require grad, each with `.grad` a view
  of the matching slot of the gradient buffer, and backward accumulates into
  those views in place (`value_and_grad_acc`).
* `step` and `rng` of the TrainState are host ints: PyTorch runs eagerly, so
  the host decides the step's control flow (the reference's traced
  `lax.cond`s). Values the step computes stay on the device.
* The numerics guard (`guard_update=True`) is slice 3 of the port and
  raises here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.optim import GradientTransform
from repro_torch.optim.fused import fused_apply
from repro_torch.utils import buckets

Tree = Any
LossFn = Callable[[dict, Any, torch.Generator], tuple[torch.Tensor, dict]]

GUARD = ("the in-step numerics guard (guard_update=True) is not ported yet: "
         "slice 3 of the port, ROADMAP.md queue 1")


class TrainState(NamedTuple):
    step: int                # steps taken
    rng: int                 # seed of the per-step generators (`step_rng`)
    params: buckets.BucketedState
    opt_state: Tree
    method_state: Tree       # method-specific carry (e.g. AsyncSAM's a_{t-1})


@dataclasses.dataclass(frozen=True)
class MethodConfig:
    """One config object for the ported methods: the reference's fields that
    sgd, sam and async_sam read, with the reference's defaults. The fields of
    the methods not ported yet (gsam's alpha, looksam_k, esam_beta, aesam_*,
    mesa_*) come with those methods.

    name: sgd | sam | async_sam (the others are not ported yet)
    rho: perturbation radius r (paper Table A.2 uses 0.05~0.1).
    ascent_fraction: b'/b for AsyncSAM (paper: {25,50,75,100}%).
    same_batch_ascent: SAM convention: ascent uses the same minibatch as
        descent (Foret et al.); AsyncSAM uses *different* samples by design.
    compressor, topk_fraction: ascent compression; only "none" is ported.
    n_microbatches: gradient accumulation over equal chunks of the batch.
    ascent_interval: refresh a_t every k steps (beyond-paper; tau <= k).
    guard_update: the in-step numerics guard; not ported, raises.
    fused_update: the flat-buffer fused path. The port has no other path, so
        None and True run it and False raises.
    """
    name: str = "async_sam"
    rho: float = 0.1
    ascent_fraction: float = 0.25
    same_batch_ascent: bool = True
    compressor: str = "none"
    topk_fraction: float = 0.01
    n_microbatches: int = 1
    ascent_interval: int = 1
    guard_update: bool = False
    fused_update: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class Method:
    """A named pair of (state init, step builder); `cfg` is the
    MethodConfig the factory closed over (attached by `core.make_method`)."""
    name: str
    init: Callable[[buckets.BucketedState, int], Tree]
    make_step: Callable[[LossFn, GradientTransform], Callable]
    cfg: Optional[MethodConfig] = None


def init_train_state(params, optimizer: GradientTransform, method: Method,
                     seed: int = 0) -> TrainState:
    """The step-0 state. `params` may be a BucketedState, a model (its
    parameters become views into the new buffers) or a mapping of name ->
    tensor; the port's state is always bucket-resident."""
    params = buckets.residentize(params)
    return TrainState(step=0, rng=seed, params=params,
                      opt_state=optimizer.init(params),
                      method_state=method.init(params, seed))


def _finish(state: TrainState, optimizer: GradientTransform,
            grads: buckets.BucketedState, method_state: Tree, metrics: dict, *,
            guard: bool = False) -> tuple[TrainState, dict]:
    """Shared tail: the fused optimizer update (in place) + state threading."""
    if guard:
        raise NotImplementedError(GUARD)
    metrics = dict(metrics)
    params, opt_state, gnorm = fused_apply(optimizer, grads, state.opt_state, state.params)
    metrics.setdefault("grad_norm", gnorm)
    return TrainState(step=state.step + 1, rng=state.rng, params=params,
                      opt_state=opt_state, method_state=method_state), metrics


def step_rng(state: TrainState, lane: int = 0) -> torch.Generator:
    """A generator seeded from (rng, step, lane): restart-stable, one stream
    per lane (descent 0, ascent 1). The olmo loss draws no randomness; the
    generator is the protocol's, for losses that do."""
    seed = int(np.random.SeedSequence([state.rng, state.step, lane]).generate_state(1)[0])
    return torch.Generator(device=state.params.device).manual_seed(seed)


class Workspace:
    """Buffers a step function reuses across steps (the perturbed weights,
    gradients, the spare ascent buffer), made at first use with the params'
    layout and held by the step's closure."""

    def __init__(self):
        self.bufs: dict[str, buckets.BucketedState] = {}

    def get(self, name: str, like: buckets.BucketedState,
            dtype: Optional[torch.dtype] = None) -> buckets.BucketedState:
        buf = self.bufs.get(name)
        if buf is None or buf.layout != like.layout:
            buf = self.bufs[name] = like.zeros_like(dtype)
        return buf


def _grad_leaves(params: buckets.BucketedState,
                 grads: buckets.BucketedState) -> dict[str, torch.Tensor]:
    """Leaf views of `params` that require grad, each with `.grad` the view
    of its slot in `grads`: backward accumulates into the gradient buffer in
    place (autograd adds into an existing .grad)."""
    views, gviews = params.to_tree(), grads.to_tree()
    for name, v in views.items():
        v.requires_grad_(True)
        v.grad = gviews[name]
    return views


def _scalars(aux: dict) -> dict:
    return {k: v.detach() for k, v in aux.items()
            if isinstance(v, torch.Tensor) and v.dim() == 0}


def value_and_grad_acc(loss_fn: LossFn, n_micro: int):
    """The counterpart of jax.value_and_grad(has_aux=True) with microbatch
    gradient accumulation.

    Returns fn(params, batch, gen, out=None) -> ((loss, aux), grads): `grads`
    is `out` (a BucketedState congruent with params, in params' dtypes) or a
    new one, zeroed and then filled by backward. With n_micro > 1 the batch's
    leading dim is split into n_micro chunks run one after another, their
    gradients summed in the buffer and divided by n_micro, as the reference
    does; aux is reduced to its scalar metrics (mean over chunks).
    """
    def fn(params: buckets.BucketedState, batch, gen: torch.Generator,
           out: Optional[buckets.BucketedState] = None):
        grads = out if out is not None else params.zeros_like()
        for buf in grads.buffers:
            buf.zero_()
        leaves = _grad_leaves(params, grads)
        if n_micro <= 1:
            loss, aux = loss_fn(leaves, batch, gen)
            loss.backward()
            return (loss.detach(), {k: v.detach() if isinstance(v, torch.Tensor) else v
                                    for k, v in aux.items()}), grads
        b = next(iter(batch.values())).shape[0]
        if b % n_micro != 0:
            raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
        chunks = [{k: v[i * (b // n_micro):(i + 1) * (b // n_micro)]
                   for k, v in batch.items()} for i in range(n_micro)]
        loss_sum, auxs = 0.0, []
        for chunk in chunks:
            loss, aux = loss_fn(leaves, chunk, gen)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
            auxs.append(_scalars(aux))
        for buf in grads.buffers:
            buf.div_(n_micro)
        aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
        return (loss_sum / n_micro, aux), grads

    return fn
