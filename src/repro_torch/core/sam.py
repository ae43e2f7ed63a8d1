"""SGD, SAM (Foret et al. 21) and Generalized SAM (Zhao et al. 22) baselines
(counterpart of `repro.core.sam`).

The synchronous references AsyncSAM is compared against. On the fused path
(resident state always) SAM and GSAM perturb with the reference's two-kernel
design: one `sq_norm` pass, which also gives the norm metric, then one
`sam_perturb` kernel per bucket.
"""
from __future__ import annotations

import torch

from repro_torch.core.api import (LossFn, Method, MethodConfig, TrainState, Workspace,
                                  _finish, step_rng, value_and_grad_acc)
from repro_torch.core.ascent import split_batch
from repro_torch.core.perturb import (gradient_norm_penalty_direction, grad_sq_norm,
                                     on_fused_path, perturb)
from repro_torch.optim import GradientTransform


def make_sgd(cfg: MethodConfig) -> Method:
    def init(params, seed):
        return ()

    def make_step(loss_fn: LossFn, optimizer: GradientTransform):
        vg = value_and_grad_acc(loss_fn, cfg.n_microbatches)
        ws = Workspace()

        def step(state: TrainState, batch):
            batch, _ = split_batch(batch)
            (loss, aux), grads = vg(state.params, batch, step_rng(state),
                                    out=ws.get("grads", state.params))
            return _finish(state, optimizer, grads, (), {"loss": loss, **_m(aux)},
                           guard=cfg.guard_update)

        return step

    return Method("sgd", init, make_step)


def _sam_grads(cfg: MethodConfig, vg, ws: Workspace, state: TrainState, batch):
    """SAM's two gradient evaluations: g_w at w on the ascent batch, then
    the gradient at w_hat = w + rho g_w / ||g_w|| on the descent batch.
    Returns (loss at w, g_w, ||g_w||^2, (loss, aux) at w_hat, its gradient)."""
    batch, ascent_batch = split_batch(batch)
    if cfg.same_batch_ascent or ascent_batch is None:
        ascent_batch = batch
    gen = step_rng(state)
    (loss_w, _), g_w = vg(state.params, ascent_batch, gen, out=ws.get("ascent", state.params))
    sq = grad_sq_norm(g_w, on_fused_path(state.params, cfg.fused_update))
    w_hat = perturb(state.params, g_w, cfg.rho, sq_norm=sq, fused=cfg.fused_update,
                    out=ws.get("w_hat", state.params))
    (loss, aux), g_hat = vg(w_hat, batch, gen, out=ws.get("grads", state.params))
    return loss_w, g_w, sq, (loss, _m(aux)), g_hat


def make_sam(cfg: MethodConfig) -> Method:
    """Vanilla SAM: two sequential gradient evaluations per step (Eq. 1)."""

    def init(params, seed):
        return ()

    def make_step(loss_fn: LossFn, optimizer: GradientTransform):
        vg = value_and_grad_acc(loss_fn, cfg.n_microbatches)
        ws = Workspace()

        def step(state: TrainState, batch):
            loss_w, _, sq, (loss, aux), grads = _sam_grads(cfg, vg, ws, state, batch)
            metrics = {"loss": loss, "loss_at_w": loss_w, "ascent_norm": torch.sqrt(sq),
                       **aux}
            return _finish(state, optimizer, grads, (), metrics, guard=cfg.guard_update)

        return step

    return Method("sam", init, make_step)


def make_gsam(cfg: MethodConfig) -> Method:
    """Generalized SAM / gradient-norm penalty: SAM's two gradients, mixed
    (1 - alpha) ∇L(w) + alpha ∇L(ŵ) in place of the second."""

    def init(params, seed):
        return ()

    def make_step(loss_fn: LossFn, optimizer: GradientTransform):
        vg = value_and_grad_acc(loss_fn, cfg.n_microbatches)
        ws = Workspace()

        def step(state: TrainState, batch):
            loss_w, g_w, _, (loss, aux), g_hat = _sam_grads(cfg, vg, ws, state, batch)
            grads = gradient_norm_penalty_direction(g_w, g_hat, cfg.alpha, out=g_hat)
            metrics = {"loss": loss, "loss_at_w": loss_w, **aux}
            return _finish(state, optimizer, grads, (), metrics, guard=cfg.guard_update)

        return step

    return Method("gsam", init, make_step)


def _m(aux: dict) -> dict:
    """Pass through scalar aux metrics only."""
    return {k: v for k, v in aux.items() if isinstance(v, torch.Tensor) and v.dim() == 0}
