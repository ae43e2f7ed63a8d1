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
* State is updated in place: the counterpart of the reference's donated jit
  buffers. By default it is bucket-resident (`utils.buckets.BucketedState`);
  `init_train_state(..., resident=False)` keeps per-leaf tensors (a mapping
  of name -> tensor), the reference's pytree state, and each step writes its
  new values back into them. Each step writes into buffers it reuses
  (`Workspace`).
* Gradients land in a gradient buffer with no gather: the loss sees leaf
  views of w (or w_hat) that require grad, each with `.grad` the matching
  tensor of the gradient buffer (a view of its slot in the flat buffer, on
  resident state), and backward accumulates into them in place
  (`value_and_grad_acc`).
* `step` and `rng` of the TrainState are host ints: PyTorch runs eagerly, so
  the host decides the step's control flow (the reference's traced
  `lax.cond`s). Values the step computes stay on the device.
* The numerics guard (`guard_update=True`) cannot tree-select the old
  state back after the update, as the reference does: the update is in
  place. Its verdict is computed on the device before the epilogue and the
  epilogue kernels take it (`_finish`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.obs.registry import scalar_metrics  # noqa: F401  (re-exported)
from repro_torch.optim import GradientTransform, apply_updates
from repro_torch.optim.fused import fused_apply
from repro_torch.utils import buckets, trees

Tree = Any
LossFn = Callable[[dict, Any, torch.Generator], tuple[torch.Tensor, dict]]


class TrainState(NamedTuple):
    step: int                # steps taken
    rng: int                 # seed of the per-step generators (`step_rng`)
    params: Tree             # a BucketedState, or a mapping of name -> tensor
    opt_state: Tree
    method_state: Tree       # method-specific carry (e.g. AsyncSAM's a_{t-1})


@dataclasses.dataclass(frozen=True)
class MethodConfig:
    """One config object for the whole family, with the reference's fields
    and defaults; a method ignores the fields it does not read.

    name: sgd | sam | async_sam | gsam | looksam | esam | aesam | mesa
    rho: perturbation radius r (paper Table A.2 uses 0.05~0.1).
    ascent_fraction: b'/b for AsyncSAM (paper: {25,50,75,100}%).
    same_batch_ascent: SAM convention: ascent uses the same minibatch as
        descent (Foret et al.); AsyncSAM uses *different* samples by design.
    alpha: GSAM mixing coefficient (0.7~0.9); LookSAM's reuse weight.
    looksam_k: LookSAM's gradient-ascent reuse interval (paper fixes 2).
    esam_beta: fraction of parameters ESAM's SWP perturbs.
    aesam_lambda_hi, aesam_ema: AE-SAM takes a SAM step when the z-score of
        ||g||^2 against its EMA (decay aesam_ema) exceeds lambda_hi.
    mesa_decay, mesa_lambda, mesa_temp, mesa_start_step: MESA's EMA decay,
        the weight and temperature of its distillation term, and the step
        from which the term is on.
    compressor, topk_fraction: ascent compression; only "none" is ported.
    n_microbatches: gradient accumulation over equal chunks of the batch
        (MESA takes one pass without it, as in the reference).
    ascent_interval: refresh a_t every k steps (beyond-paper; tau <= k).
    guard_update: the in-step numerics guard: a non-finite loss or gradient
        norm discards the update (params and optimizer state unchanged, step
        advanced so the batch is consumed) and the step emits update_skipped
        and nonfinite_count. Honoured by sgd, sam, gsam and async_sam, the
        methods the guard ladder drives; the variants ignore it, as in the
        reference.
    fused_update: the flat-buffer fused path (perturb, ascent-refresh
        dot/norms, the optimizer epilogue) for per-leaf state; bucket-resident
        state always takes it. None and True take it, False keeps per-leaf
        state on the reference's per-leaf composition. Executors resolve and
        pin it; the matching optimizer-epilogue switch is FusedSpec.enabled.
    """
    name: str = "async_sam"
    rho: float = 0.1
    ascent_fraction: float = 0.25
    same_batch_ascent: bool = True
    alpha: float = 0.8
    looksam_k: int = 2
    esam_beta: float = 0.6
    aesam_lambda_hi: float = 1.0
    aesam_ema: float = 0.9
    mesa_decay: float = 0.995
    mesa_lambda: float = 0.8
    mesa_temp: float = 1.5
    mesa_start_step: int = 200
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


def per_leaf(params) -> dict[str, torch.Tensor]:
    """A model's parameters (or a mapping of name -> tensor) as the per-leaf
    state's mapping: detached tensors sharing the parameters' storage, so the
    model reads what the steps write."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return {name: t.detach() for name, t in params.items()}


def init_train_state(params, optimizer: GradientTransform, method: Method,
                     seed: int = 0, *, resident: bool = True) -> TrainState:
    """The step-0 state. `params` may be a BucketedState, a model or a
    mapping of name -> tensor. Resident (the default), a model's parameters
    become views into the new buffers; per-leaf, the state holds the
    parameters' own tensors (`per_leaf`)."""
    params = buckets.residentize(params) if resident else per_leaf(params)
    return TrainState(step=0, rng=seed, params=params,
                      opt_state=optimizer.init(params),
                      method_state=method.init(params, seed))


def _finish(state: TrainState, optimizer: GradientTransform, grads: Tree,
            method_state: Tree, metrics: dict, *,
            guard: bool = False) -> tuple[TrainState, dict]:
    """Shared tail: the optimizer update, in place, + state threading.

    A canonical sgd/adamw chain takes the fused flat-buffer path
    (`optim.fused.fused_apply`); anything else the per-leaf chain's update +
    `apply_updates`, whose results are written back into the state's tensors.

    guard=True (MethodConfig.guard_update) adds the in-step numerics check.
    The verdict keep = isfinite(||g||) & isfinite(loss) is a 0-d fp32 device
    tensor computed before any state is written: the fused path hands it to
    the epilogue kernels (at 0 they write nothing, and the step counters keep
    their values through torch.where); the per-leaf path selects each leaf
    with torch.where, as the reference tree-selects. The step counter of the
    TrainState still advances, so the batch is consumed, not replayed. The
    step then carries `update_skipped` (1 - keep) and `nonfinite_count` (one
    more reduction over the gradient, paid only with the guard on). The
    methods that honour the guard here carry no method state except
    async_sam, which decides its carry itself (`core.async_sam`).
    """
    metrics = dict(metrics)
    verdict: dict = {}

    def keep_of(gnorm: torch.Tensor) -> torch.Tensor:
        ok = torch.isfinite(gnorm)
        loss = metrics.get("loss")
        if loss is not None:
            ok = ok & torch.isfinite(torch.as_tensor(loss, device=gnorm.device))
        verdict["keep"] = ok.float()
        return verdict["keep"]

    fused = fused_apply(optimizer, grads, state.opt_state, state.params,
                        verdict=keep_of if guard else None)
    if fused is not None:
        params, opt_state, gnorm = fused
    else:
        if buckets.is_bucketed(state.params):
            raise TypeError("bucket-resident params need an optimizer with a FusedSpec "
                            "(optim.sgd / optim.adamw without a decay mask)")
        updates, new_opt = optimizer.update(grads, state.opt_state, state.params)
        new_params = apply_updates(state.params, updates)
        gnorm = trees.global_norm(grads)
        if guard:
            ok = keep_of(gnorm) != 0
            kept = lambda n, o: torch.where(ok, n, o)  # noqa: E731
            new_params = trees.tree_map(kept, new_params, state.params)
            new_opt = trees.tree_map(kept, new_opt, state.opt_state)
        params = trees.tree_copy_(state.params, new_params)
        opt_state = trees.tree_copy_(state.opt_state, new_opt)
    metrics.setdefault("grad_norm", gnorm)
    if guard:
        metrics["update_skipped"] = 1.0 - verdict["keep"]
        metrics["nonfinite_count"] = sum(
            torch.sum(~torch.isfinite(g)) for g in trees.tree_leaves(grads)).float()
    return TrainState(step=state.step + 1, rng=state.rng, params=params,
                      opt_state=opt_state, method_state=method_state), metrics


def params_device(params: Tree) -> torch.device:
    return trees.tree_leaves(params)[0].device


def step_rng(state: TrainState, lane: int = 0) -> torch.Generator:
    """A generator seeded from (rng, step, lane): restart-stable, one stream
    per lane (descent 0, ascent 1). The olmo loss draws no randomness; the
    generator is the protocol's, for losses that do."""
    seed = int(np.random.SeedSequence([state.rng, state.step, lane]).generate_state(1)[0])
    return torch.Generator(device=params_device(state.params)).manual_seed(seed)


def lane_key(state: TrainState) -> np.ndarray:
    """The ascent job's rng as the lanes and the wire carry it: a uint32[2]
    key derived from (rng, step), where the reference ships
    `jax.random.fold_in(rng, step)` (a key of the same shape and dtype, so a
    server of either package sees the input tree it expects)."""
    return np.random.SeedSequence([state.rng, state.step]).generate_state(2, dtype=np.uint32)


def key_generator(key, device) -> torch.Generator:
    """A generator on `device` seeded from a key off the wire (the port's
    `lane_key` or the reference's PRNG key data), as `step_rng` seeds from
    (rng, step, lane)."""
    words = [int(x) for x in np.asarray(key).reshape(-1)]
    seed = int(np.random.SeedSequence(words).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _congruent(a: Tree, b: Tree) -> bool:
    if buckets.is_bucketed(a) or buckets.is_bucketed(b):
        return (buckets.is_bucketed(a) and buckets.is_bucketed(b)
                and a.layout == b.layout)
    return (a.keys() == b.keys()
            and all(a[k].shape == b[k].shape for k in a))


class Workspace:
    """Buffers a step function reuses across steps (the perturbed weights,
    gradients, the spare ascent buffer), made at first use in the params'
    form (the same layout, or the same leaves) and held by the step's
    closure."""

    def __init__(self):
        self.bufs: dict[str, Tree] = {}

    def get(self, name: str, like: Tree, dtype: Optional[torch.dtype] = None) -> Tree:
        buf = self.bufs.get(name)
        if buf is None or not _congruent(buf, like):
            buf = self.bufs[name] = trees.tree_zeros_like(like, dtype)
        return buf


def _grad_leaves(params: Tree, grads: Tree) -> dict[str, torch.Tensor]:
    """Leaf views of `params` that require grad, each with `.grad` the
    matching tensor of `grads` (on resident state a view of its slot in the
    flat buffer): backward accumulates into the gradient buffer in place
    (autograd adds into an existing .grad)."""
    if buckets.is_bucketed(params):
        views, gviews = params.to_tree(), grads.to_tree()
    else:
        views, gviews = per_leaf(params), grads
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
    is `out` (congruent with params, in params' dtypes: a BucketedState or a
    mapping of tensors) or a new one, zeroed and then filled by backward.
    With n_micro > 1 the batch's leading dim is split into n_micro chunks run
    one after another, their gradients summed in the buffer and divided by
    n_micro, as the reference does; aux is reduced to its scalar metrics
    (mean over chunks).
    """
    def fn(params: Tree, batch, gen: torch.Generator, out: Optional[Tree] = None):
        grads = out if out is not None else trees.tree_zeros_like(params)
        for buf in trees.tree_leaves(grads):
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
        for buf in trees.tree_leaves(grads):
            buf.div_(n_micro)
        aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
        return (loss_sum / n_micro, aux), grads

    return fn
