"""Computation-efficient SAM baselines the paper compares against (Table 4.1)
(counterpart of `repro.core.variants`).

LookSAM (Liu et al. 22)   reuses the ascent direction's novel component for k steps.
ESAM    (Du et al. 22a)   perturbs a random subset of the parameters (SWP).
AE-SAM  (Jiang et al. 23) takes a SAM step only in sharp regions.
MESA    (Du et al. 22b)   sharpness-aware for free: an EMA-trajectory loss term.

Each follows the `core.api` step protocol, so a harness swaps methods with one
flag. What differs from the reference, and why:
* The host decides the control flow, as in the rest of the port: LookSAM's
  fresh-or-reuse and AE-SAM's SAM-or-SGD are host branches where the
  reference traces `lax.cond`. LookSAM's depends on host values only (the
  step, whether g_v is held). AE-SAM's depends on ||g||^2 once its warm-up no
  longer forces SAM steps: the step then reads z to the host, one device
  synchronisation a step and the only one a method's step makes. The host
  waits there for the first gradient pass, so the second pass's launches no
  longer queue up behind it.
* ESAM draws its Bernoulli(beta) mask from the step's generator
  (`esam_mask`), one bool a parameter: its bits cannot be `jax.random`'s, so
  a test replaces the function with the reference's mask. The mask is
  applied to the gradient in place, so the step holds no second
  gradient-sized float tree.
* MESA's EMA forward runs under `torch.no_grad`, through the loss's
  mapping-of-tensors protocol; like the reference it takes one gradient
  pass, without microbatch accumulation.
* On the fused path each weight-space pass runs the flat-buffer kernels: the
  norms `sq_norm`, the perturbation `sam_perturb`, LookSAM's projection and
  reuse `fused_dot_norms` + `fused_axpy`, the update the optimizer's epilogue
  (`core.api._finish`). Under `FusedExecutor` these methods keep per-leaf
  state, as in the reference, so each such call gathers its operands into
  buckets; with `fused_update=False` they are the reference's per-leaf
  compositions.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.api import (LossFn, Method, MethodConfig, TrainState, Workspace,
                                  _finish, _grad_leaves, params_device, step_rng,
                                  value_and_grad_acc)
from repro_torch.core.ascent import split_batch
from repro_torch.core.perturb import grad_sq_norm, on_fused_path, perturb
from repro_torch.core.sam import _m
from repro_torch.optim import GradientTransform
from repro_torch.utils import buckets, trees

Tree = Any
_EPS = 1e-12


# ---------------------------------------------------------------------------
# LookSAM
# ---------------------------------------------------------------------------

class LookSamState(NamedTuple):
    g_v: Tree            # fp32: the component of ∇L(ŵ) orthogonal to ∇L(w), reused k-1 steps
    have_gv: bool        # g_v holds a direction


def _axpy_f32(dst: Tree, alpha: torch.Tensor, x: Tree, y: Tree) -> Tree:
    """dst = y + alpha x, summed in fp32 into the fp32 tree `dst` (congruent
    with x and y): one `fused_axpy` kernel per bucket. A y that is not all
    fp32 is first copied into dst, so the kernel adds in fp32."""
    with torch.no_grad():
        if any(t.dtype != torch.float32 for t in trees.tree_leaves(y)):
            y = trees.tree_copy_(dst, y)
        if buckets.is_bucketed(dst):
            return buckets.bucketed_axpy(alpha, x, y, out=dst)
        return trees.tree_copy_(dst, buckets.bucketed_axpy(alpha, x, y))


def make_looksam(cfg: MethodConfig) -> Method:
    k = max(1, cfg.looksam_k)

    def init(params, seed):
        return LookSamState(g_v=trees.tree_zeros_like(params, torch.float32), have_gv=False)

    def make_step(loss_fn: LossFn, optimizer: GradientTransform):
        vg = value_and_grad_acc(loss_fn, cfg.n_microbatches)
        ws = Workspace()

        def fresh_step(w, batch, gen, g_v):
            """SAM's two gradients; g_v takes the second's component
            orthogonal to the first. Returns (the second gradient, its loss)."""
            fused = on_fused_path(w, cfg.fused_update)
            _, g_w = vg(w, batch, gen, out=ws.get("g_w", w))
            sq = grad_sq_norm(g_w, fused)
            w_hat = perturb(w, g_w, cfg.rho, sq_norm=sq, fused=cfg.fused_update,
                            out=ws.get("w_hat", w))
            (loss, _), g_s = vg(w_hat, batch, gen, out=ws.get("grads", w))
            if fused:
                dot, _, _ = buckets.bucketed_dot_norms(g_s, g_w)
                _axpy_f32(g_v, -dot / (sq + _EPS), g_w, g_s)
            else:
                coef = trees.tree_dot(g_s, g_w) / (sq + _EPS)
                trees.tree_copy_(g_v, trees.tree_map(
                    lambda gs, gw: gs.float() - coef * gw.float(), g_s, g_w))
            return g_s, loss

        def reuse_step(w, batch, gen, g_v):
            """One gradient: g + alpha ||g|| / ||g_v|| g_v (LookSAM Eq. 5)."""
            (loss, _), g = vg(w, batch, gen, out=ws.get("grads", w))
            if on_fused_path(w, cfg.fused_update):
                _, sq_g, sq_v = buckets.bucketed_dot_norms(g, g_v)
                scale = cfg.alpha * torch.sqrt(sq_g) / (torch.sqrt(sq_v) + _EPS)
                grads = buckets.bucketed_axpy(scale, g_v, g,
                                              out=g if buckets.is_bucketed(g) else None)
            else:
                scale = cfg.alpha * trees.global_norm(g) / (trees.global_norm(g_v) + _EPS)
                grads = trees.tree_map(lambda gi, gv: (gi.float() + scale * gv).to(gi.dtype),
                                       g, g_v)
            return grads, loss

        def step(state: TrainState, batch):
            batch, _ = split_batch(batch)
            ms: LookSamState = state.method_state
            fresh = state.step % k == 0 or not ms.have_gv
            run = fresh_step if fresh else reuse_step
            grads, loss = run(state.params, batch, step_rng(state), ms.g_v)
            return _finish(state, optimizer, grads, LookSamState(g_v=ms.g_v, have_gv=True),
                           {"loss": loss, "fresh": 1.0 if fresh else 0.0})

        return step

    return Method("looksam", init, make_step)


# ---------------------------------------------------------------------------
# ESAM (stochastic weight perturbation)
# ---------------------------------------------------------------------------

def esam_mask(grads: Tree, beta: float, gen: torch.Generator) -> Tree:
    """ESAM's Bernoulli(beta) element mask over every leaf (or bucket) of
    `grads`, drawn from `gen` as bool tensors: a byte an element, where an
    fp32 mask would be as large as the gradient."""
    return trees.tree_map(
        lambda g: torch.empty(g.shape, dtype=torch.bool, device=g.device).bernoulli_(
            beta, generator=gen), grads)


def make_esam(cfg: MethodConfig) -> Method:
    """ESAM-SWP: perturb a Bernoulli(beta) random subset of the parameters.

    The perturbation's norm is taken over the masked gradient, so its radius
    stays rho (`core.perturb.perturb_masked`'s rule). The data-selection half
    (SDS) is left out, as in the reference."""

    def init(params, seed):
        return ()

    def make_step(loss_fn: LossFn, optimizer: GradientTransform):
        vg = value_and_grad_acc(loss_fn, cfg.n_microbatches)
        ws = Workspace()

        def step(state: TrainState, batch):
            batch, _ = split_batch(batch)
            w = state.params
            gen = step_rng(state)
            _, g_w = vg(w, batch, gen, out=ws.get("g_w", w))
            # the mask multiplies g_w in place: g_w serves only the perturbation
            with torch.no_grad():
                masked = trees.tree_map(lambda g, m: g.mul_(m), g_w,
                                        esam_mask(g_w, cfg.esam_beta, gen))
            w_hat = perturb(w, masked, cfg.rho, fused=cfg.fused_update, out=ws.get("w_hat", w))
            (loss, aux), grads = vg(w_hat, batch, gen, out=ws.get("grads", w))
            return _finish(state, optimizer, grads, (), {"loss": loss, **_m(aux)})

        return step

    return Method("esam", init, make_step)


# ---------------------------------------------------------------------------
# AE-SAM (adaptive SAM employment)
# ---------------------------------------------------------------------------

class AeSamState(NamedTuple):
    mean: torch.Tensor   # EMA of ||g||^2 (fp32 device scalar)
    var: torch.Tensor    # EMA of (||g||^2 - mean)^2
    count: int           # steps taken


AESAM_WARMUP = 8         # the first steps are SAM steps, whatever z


def make_aesam(cfg: MethodConfig) -> Method:
    """AE-SAM: a SAM step only when ||g||^2 is high against its EMA (z-score
    above lambda_hi), else plain SGD: sharp regions get SAM."""

    def init(params, seed):
        dev = params_device(params)
        return AeSamState(mean=torch.zeros((), dtype=torch.float32, device=dev),
                          var=torch.ones((), dtype=torch.float32, device=dev), count=0)

    def make_step(loss_fn: LossFn, optimizer: GradientTransform):
        vg = value_and_grad_acc(loss_fn, cfg.n_microbatches)
        ws = Workspace()

        def step(state: TrainState, batch):
            batch, _ = split_batch(batch)
            ms: AeSamState = state.method_state
            w = state.params
            gen = step_rng(state)
            (loss_w, _), g_w = vg(w, batch, gen, out=ws.get("g_w", w))
            sq = grad_sq_norm(g_w, on_fused_path(w, cfg.fused_update))
            z = (sq - ms.mean) / (torch.sqrt(ms.var) + _EPS)
            # the host's branch: after the warm-up, one read of z a step
            take_sam = ms.count < AESAM_WARMUP or bool(z > cfg.aesam_lambda_hi)
            if take_sam:
                w_hat = perturb(w, g_w, cfg.rho, sq_norm=sq, fused=cfg.fused_update,
                                out=ws.get("w_hat", w))
                (loss, _), grads = vg(w_hat, batch, gen, out=ws.get("grads", w))
            else:
                loss, grads = loss_w, g_w
            d = cfg.aesam_ema
            new_ms = AeSamState(mean=d * ms.mean + (1 - d) * sq,
                                var=d * ms.var + (1 - d) * torch.square(sq - ms.mean),
                                count=ms.count + 1)
            return _finish(state, optimizer, grads, new_ms,
                           {"loss": loss, "sam_step": 1.0 if take_sam else 0.0, "gnorm_sq": sq})

        return step

    return Method("aesam", init, make_step)


# ---------------------------------------------------------------------------
# MESA (memory-efficient sharpness-aware training for free)
# ---------------------------------------------------------------------------

class MesaState(NamedTuple):
    ema_params: Tree     # fp32 EMA of the parameters, the params' form


def make_mesa(cfg: MethodConfig) -> Method:
    """MESA: one gradient pass on  L(w) + lambda KL(f_ema || f_w)  (at
    temperature mesa_temp, on from step mesa_start_step), where f_ema is the
    model at the EMA of the parameters: the trajectory gives the sharpness
    signal. The loss callback must expose aux["logits"]; a sharded one may
    give aux["position_mean"], the mean over positions that lie across its
    ranks (`engine.fused`), else the KL is the mean over the logits'."""
    t = cfg.mesa_temp

    def init(params, seed):
        return MesaState(ema_params=trees.tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params))

    def make_step(loss_fn: LossFn, optimizer: GradientTransform):
        ws = Workspace()

        def step(state: TrainState, batch):
            batch, _ = split_batch(batch)
            ms: MesaState = state.method_state
            w = state.params
            gen = step_rng(state)
            active = state.step >= cfg.mesa_start_step
            grads = ws.get("grads", w)
            for buf in trees.tree_leaves(grads):
                buf.zero_()
            loss, aux = loss_fn(_grad_leaves(w, grads), batch, gen)
            if "logits" not in aux:
                raise ValueError("MESA requires loss_fn aux to include 'logits'")
            ema = ms.ema_params
            with torch.no_grad():
                _, ema_aux = loss_fn(buckets.tree_view(ema), batch, gen)
                p_ema = torch.softmax(ema_aux["logits"].float() / t, dim=-1)
                del ema_aux
            with torch.set_grad_enabled(active):   # inactive: the term is only a metric
                logq = torch.log_softmax(aux["logits"].float() / t, dim=-1)
                # a sharded loss's positions lie across ranks: its mean is theirs
                mean = aux.get("position_mean", torch.mean)
                kl = -mean(torch.sum(p_ema * logq, dim=-1)) * t * t
                total = loss + cfg.mesa_lambda * kl if active else loss
            total.backward()
            del p_ema, logq
            # the EMA takes the step's params before the update changes them in place
            d = cfg.mesa_decay
            with torch.no_grad():
                trees.tree_map(lambda e, p: e.mul_(d).add_(p, alpha=1 - d), ema, w)
            metrics = {"loss": total.detach(), "mesa_kl": kl.detach(),
                       **{k: v.detach() for k, v in _m(aux).items()}}
            return _finish(state, optimizer, grads, ms, metrics)

        return step

    return Method("mesa", init, make_step)
