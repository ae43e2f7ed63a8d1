"""AsyncSAM, the paper's contribution (Algorithm 1), Form A (counterpart of
`make_async_sam` in `repro.core.async_sam`).

Because tau = 1 removes the ascent -> descent dependency, one step computes
both

    g_t = ∇L^b ( w_t + r * a_{t-1} / ||a_{t-1}|| )     (descent, perturbed)
    a_t = ∇L^{b'} ( w_t )                               (next ascent)

The reference jits the two gradients as independent dataflow nodes; on one
card the port runs them in sequence on one stream, which computes the same
values. The order, on bucket-resident state:

  1. a_t at w, on the ascent batch, into the spare ascent buffer;
  2. w_hat = fused_axpy(rho / ||a_{t-1}||, a_{t-1}, w) into its own buffer;
  3. g at w_hat, on the descent batch, into the gradient buffer;
  4. the optimizer update in place (fused: sq_norm + sgd_epilogue or
     adamw_epilogue per bucket);
  5. fused_dot_norms(a_t, a_{t-1}): the carried norm and the cosine;
  6. swap the two ascent buffers.

That is the fused path, which bucket-resident state always takes. Per-leaf
state (`FusedExecutor(resident=False)`) takes it too, gathering into buckets
per call, unless `fused_update` is False: then the perturbation and the
refresh are the reference's per-leaf compositions.

At t = 0 no ascent gradient exists: rho_eff = 0 degrades the step to SGD
(Algorithm 1, line 8) with the same kernels launched. A lossy compressor
(`MethodConfig.compressor` "int8" / "topk") keeps the carried gradient
compressed, with error feedback, as the reference does.

Form B, the split phases of the heterogeneous executor
(`runtime.async_executor`), is `make_ascent_fn` (the ascent gradient on
whatever resource runs the ascent lane) and `make_descent_fn` (one update
given the held ascent gradient).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

import numpy as np

from repro_torch.core.api import (LossFn, Method, MethodConfig, TrainState, Workspace,
                                  _finish, params_device, step_rng, value_and_grad_acc)
from repro_torch.core.ascent import (CompressionState, Compressor, slice_ascent_batch,
                                     split_batch)
from repro_torch.core.perturb import on_fused_path, perturb
from repro_torch.core.sam import _m
from repro_torch.models import convert
from repro_torch.optim import GradientTransform
from repro_torch.utils import buckets, trees

Tree = Any


class AsyncSamState(NamedTuple):
    """Carry across steps: the ascent gradient a_{t-tau}."""
    ascent_grad: Tree                    # a_{t-1}, fp32, params' form; zeros at first
    ascent_norm: torch.Tensor            # ||a_{t-1}|| (fp32 device scalar)
    have_ascent: bool                    # a valid gradient is held
    staleness: int                       # age of the held gradient (tau)
    compression: CompressionState        # error-feedback residual ((), lossless)


def _init_state(params: Tree, compressor: Compressor) -> AsyncSamState:
    return AsyncSamState(
        ascent_grad=trees.tree_zeros_like(params, torch.float32),
        ascent_norm=torch.zeros((), dtype=torch.float32, device=params_device(params)),
        have_ascent=False,
        staleness=0,
        compression=compressor.init(params),
    )


def make_async_sam(cfg: MethodConfig) -> Method:
    compressor = Compressor(kind=cfg.compressor, topk_fraction=cfg.topk_fraction)

    def init(params, seed):
        return _init_state(params, compressor)

    def make_step(loss_fn: LossFn, optimizer: GradientTransform):
        vg = value_and_grad_acc(loss_fn, cfg.n_microbatches)
        ws = Workspace()

        def step(state: TrainState, batch):
            batch, ascent_batch = split_batch(batch)
            if ascent_batch is None:
                ascent_batch = slice_ascent_batch(batch, cfg.ascent_fraction)
            ms: AsyncSamState = state.method_state
            w = state.params

            # --- 1. the NEXT ascent gradient at the unperturbed w (line 3).
            # ascent_interval > 1 (beyond-paper "AsyncSAM-k") refreshes only
            # every k-th step; a reused step reports a NaN ascent_loss
            # SENTINEL (no ascent pass ran), disambiguated by ascent_reused.
            refresh = cfg.ascent_interval <= 1 or state.step % cfg.ascent_interval == 0
            if refresh:
                spare = ws.get("ascent", w, torch.float32)
                fp32 = all(b.dtype == torch.float32 for b in trees.tree_leaves(w))
                (loss_asc, _), a_new = vg(w, ascent_batch, step_rng(state, lane=1),
                                          out=spare if fp32 else ws.get("a_raw", w))
                if a_new is not spare:           # non-fp32 params: cast into fp32
                    a_new = trees.tree_copy_(spare, a_new)
                staleness, reused = 1, 0.0
            else:
                a_new = ms.ascent_grad
                loss_asc = torch.full((), float("nan"), device=w.device)
                staleness, reused = ms.staleness + 1, 1.0

            # --- 2. perturb with the STALE gradient a_{t-1} (line 5); at t=0
            # rho_eff = 0 gives w_hat = w (line 8)
            rho_eff = cfg.rho if ms.have_ascent else 0.0
            w_hat = perturb(w, ms.ascent_grad, rho_eff, grad_norm=ms.ascent_norm,
                            fused=cfg.fused_update, out=ws.get("w_hat", w))

            # --- 3. descent gradient at the perturbed point (line 6)
            (loss, aux), grads = vg(w_hat, batch, step_rng(state, lane=0),
                                    out=ws.get("grads", w))
            aux = _m(aux)

            # --- 4. the optimizer update, in place
            new_state, metrics = _finish(state, optimizer, grads, None, {}, guard=cfg.guard_update)

            # --- 5. ascent-state refresh: on the fused path the cosine metric
            # and the carried norm from ONE pass over (a_t, a_{t-1}); lossless
            # only, since compression changes the stored gradient
            comp_state = ms.compression
            if on_fused_path(w, cfg.fused_update) and cfg.compressor == "none":
                dot, sq_new, sq_old = buckets.bucketed_dot_norms(a_new, ms.ascent_grad)
                cos = dot / (torch.sqrt(sq_new) * torch.sqrt(sq_old) + 1e-12)
                a_norm = torch.sqrt(sq_new)
            else:
                cos = trees.tree_cosine_similarity(a_new, ms.ascent_grad)
                a_new, comp_state = compressor.compress(a_new, ms.compression)
                a_new = trees.tree_cast(a_new, torch.float32)
                a_norm = trees.global_norm(a_new)
            new_ms = AsyncSamState(ascent_grad=a_new, ascent_norm=a_norm,
                                   have_ascent=True, staleness=staleness,
                                   compression=comp_state)

            # --- 6. swap: a_{t-1}'s buffer takes the next a_t
            if refresh:
                ws.bufs["ascent"] = ms.ascent_grad

            metrics = {"loss": loss, "ascent_loss": loss_asc,
                       "ascent_norm": new_ms.ascent_norm, "ascent_cosine": cos,
                       "ascent_reused": reused,
                       "perturbed": 1.0 if ms.have_ascent else 0.0,
                       **aux, **metrics}
            return new_state._replace(method_state=new_ms), metrics

        return step

    return Method("async_sam", init, make_step)


# ---------------------------------------------------------------------------
# Split-phase API (Form B): used by the heterogeneous async executor
# ---------------------------------------------------------------------------

def make_ascent_fn(loss_fn: LossFn):
    """The ascent phase: (params, batch, gen) -> (grad fp32, norm, loss).

    Runs on the slow resource. `params` is the lane hand-off: the reference's
    nested tree (per-block leaves stacked, `models.convert.to_reference`) of
    tensors on the device the lane computes on, never the live model's. The
    loss sees port names whose block leaves are views of the stacked
    leaves, and backward accumulates into a gradient tree of the same shape,
    so the gradient comes back in the hand-off's form with no stacking.
    """
    def ascent(params, batch, gen):
        params = trees.tree_map(torch.Tensor.detach, params)
        grads = trees.tree_zeros_like(params)
        leaves, gleaves = convert.from_reference(params), convert.from_reference(grads)
        for name, v in leaves.items():
            v.requires_grad_(True)
            v.grad = gleaves[name]
        loss, _ = loss_fn(leaves, batch, gen)
        loss.backward()
        g = trees.tree_cast(grads, torch.float32)
        return g, trees.global_norm(g), loss.detach()

    return ascent


def make_descent_fn(cfg: MethodConfig, loss_fn: LossFn, optimizer: GradientTransform):
    """The descent phase: one model update given a held ascent gradient.

    (state, batch, a, a_norm, have_a) -> (state, metrics). `have_a` False
    (the straggler fallback past max staleness) degrades the step to plain
    SGD (rho 0). `a` arrives in the hand-off's form (a host tree of fp32
    numpy arrays) or is None (nothing held: zeros); it is gathered once
    against the state's layout, into a buffer the next steps reuse while the
    same `a` is held. Then `perturb` runs `fused_axpy` and `_finish` the
    optimizer's epilogue kernel, as in Form A.
    """
    vg = value_and_grad_acc(loss_fn, 1)
    ws = Workspace()
    gathered = {"src": None}

    def held(a, w):
        if a is None:
            return ws.get("a_zero", w, torch.float32)
        if buckets.is_bucketed(a):
            return a
        dev = params_device(w)
        named = convert.from_reference(a)
        if not buckets.is_bucketed(w):
            return {n: torch.from_numpy(np.array(named[n], np.float32)).to(dev) for n in w}
        buf = ws.get("a", w, torch.float32)
        if gathered["src"] is not a or buf is not gathered.get("buf"):
            for dst, grp in zip(buf.buffers, w.layout.groups):
                host = np.empty(grp.size, np.float32)
                for n, off, size in zip(grp.names, grp.offsets, grp.sizes):
                    host[off:off + size] = np.asarray(named[n]).reshape(-1)
                dst.copy_(torch.from_numpy(host))
            gathered.update(src=a, buf=buf)
        return buf

    def descent(state: TrainState, batch, a, a_norm: float, have_a: bool):
        batch, _ = split_batch(batch)
        w = state.params
        rho_eff = cfg.rho if have_a else 0.0
        norm = torch.full((), a_norm, dtype=torch.float32, device=params_device(w))
        w_hat = perturb(w, held(a, w), rho_eff, grad_norm=norm, fused=cfg.fused_update,
                        out=ws.get("w_hat", w))
        (loss, aux), grads = vg(w_hat, batch, step_rng(state), out=ws.get("grads", w))
        return _finish(state, optimizer, grads, state.method_state,
                       {"loss": loss, **_m(aux)}, guard=cfg.guard_update)

    return descent
