"""SGD and SAM (Foret et al. 21) baselines (counterpart of `repro.core.sam`).

The synchronous references AsyncSAM is compared against. Generalized SAM
(`make_gsam`) is not ported yet (ROADMAP.md queue 1, method variants).
"""
from __future__ import annotations

import torch

from repro_torch.core.api import (LossFn, Method, MethodConfig, TrainState, Workspace,
                                  _finish, step_rng, value_and_grad_acc)
from repro_torch.core.ascent import split_batch
from repro_torch.core.perturb import perturb
from repro_torch.optim import GradientTransform
from repro_torch.utils import buckets, trees


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


def make_sam(cfg: MethodConfig) -> Method:
    """Vanilla SAM: two sequential gradient evaluations per step (Eq. 1)."""

    def init(params, seed):
        return ()

    def make_step(loss_fn: LossFn, optimizer: GradientTransform):
        vg = value_and_grad_acc(loss_fn, cfg.n_microbatches)
        ws = Workspace()

        def step(state: TrainState, batch):
            batch, ascent_batch = split_batch(batch)
            if cfg.same_batch_ascent or ascent_batch is None:
                ascent_batch = batch
            gen = step_rng(state)
            # --- gradient ascent (perturbation): on the fused path one
            # sq_norm pass gives both the norm metric and the sam_perturb
            # kernel's scale
            (loss_w, _), g_ascent = vg(state.params, ascent_batch, gen,
                                       out=ws.get("ascent", state.params))
            fused = buckets.is_bucketed(state.params) or cfg.fused_update is not False
            sq = buckets.bucketed_sq_norm(g_ascent) if fused else trees.tree_sq_norm(g_ascent)
            w_hat = perturb(state.params, g_ascent, cfg.rho, sq_norm=sq,
                            fused=cfg.fused_update, out=ws.get("w_hat", state.params))
            # --- gradient descent at the perturbed point ---
            (loss, aux), grads = vg(w_hat, batch, gen, out=ws.get("grads", state.params))
            metrics = {"loss": loss, "loss_at_w": loss_w, "ascent_norm": torch.sqrt(sq),
                       **_m(aux)}
            return _finish(state, optimizer, grads, (), metrics, guard=cfg.guard_update)

        return step

    return Method("sam", init, make_step)


def _m(aux: dict) -> dict:
    """Pass through scalar aux metrics only."""
    return {k: v for k, v in aux.items() if isinstance(v, torch.Tensor) and v.dim() == 0}
