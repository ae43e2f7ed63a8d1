"""FusedUpdate: the canonical sgd/adamw chains on dtype-bucketed flat buffers
(counterpart of `repro.optim.fused`).

`fused_apply` runs the whole optimizer tail (global grad norm, clip, weight
decay, momentum or Adam, lr, apply) as one `sq_norm` and one epilogue kernel
(`sgd_epilogue` or `adamw_epilogue`) per dtype bucket. On bucket-resident
state (`utils.buckets.BucketedState`) the kernels update w and the moments
in place, the port's counterpart of the reference's jit donation. A state of
per-leaf tensors (`FusedExecutor(resident=False)`) is gathered into buckets
for the call and the results are written back into its tensors, the
reference's gather/scatter-per-call regime. Either way it consumes and
produces the reference's `opt_state` tuple layout (`_chain_fields`), so the
fused and per-leaf paths interoperate. The clip scale, learning rate and
bias corrections are computed on the device from device step counters, so
the host never waits for them.

With `verdict` (the numerics guard, `core.api._finish(guard=True)`), the
keep flag `verdict(grad_norm)` is computed on the device after the norm and
before the epilogues, which take it: at 0 they write nothing, and the step
counters (`AdamState.step`, `ScaleByScheduleState.step`) and
`ClipState.last_norm` keep their values through `torch.where`, so a skipped
step leaves the whole optimizer state as it was with no host read.

Hand-built chains, masked weight decay and a chain configured off
(`configure(opt, False)`) return None here and keep the per-leaf path, as in
the reference.

`epilogue_hbm_bytes` is a copy of the reference's model of the epilogue's
device-memory traffic; chip_smoke.py reads it as the bound of the step's
weight-space work.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.optim.base import (AdamState, ClipState, FusedSpec, GradientTransform,
                                    ScaleByScheduleState)
from repro_torch.utils import buckets, trees

Tree = Any


def configure(optimizer: GradientTransform, enabled: Optional[bool]) -> GradientTransform:
    """Pin the fused-path switch on a recognized chain (no-op otherwise)."""
    if optimizer.fused_spec is None:
        return optimizer
    return optimizer._replace(fused_spec=dataclasses.replace(optimizer.fused_spec,
                                                             enabled=enabled))


def _chain_fields(spec: FusedSpec) -> list[str]:
    """The transform sequence base.sgd/base.adamw built (state tuple layout)."""
    parts = []
    if spec.clip_norm is not None:
        parts.append("clip")
    if spec.family == "adamw":
        parts.append("adam")
        if spec.weight_decay:
            parts.append("wd")
    else:
        if spec.weight_decay:
            parts.append("wd")
        if spec.momentum:
            parts.append("trace")
    parts.append("lr")
    return parts


def fused_apply(optimizer: GradientTransform, grads: Tree, opt_state: tuple, params: Tree, *,
                impl: Optional[str] = None,
                verdict: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                ) -> Optional[tuple[Tree, tuple, torch.Tensor]]:
    """Run the whole update + apply on buckets, in place, or return None to
    keep the per-leaf path.

    Returns (params, new_opt_state, grad_norm): `params` and the moments are
    the same objects, their tensors updated; grad_norm is the global fp32
    gradient norm (computed for clipping anyway, and the step's contract
    metric). Bucket-resident params always run fused: the buffers are the
    representation. `verdict(grad_norm)` -> a 0-d fp32 keep flag: see the
    module docstring.
    """
    spec = optimizer.fused_spec
    resident = buckets.is_bucketed(params)
    if spec is None or not (resident or buckets.fused_path_enabled(spec.enabled)):
        return None
    fields = _chain_fields(spec)
    layout = params.layout if resident else buckets.bucket_layout(params)
    gathered = []                      # (per-leaf tree, its buckets) to write back

    def bufs(tree) -> list[torch.Tensor]:
        out, _ = buckets.group_buffers(tree, layout)
        if not buckets.is_bucketed(tree):
            gathered.append((tree, out))
        return out

    wb, gb = bufs(params), buckets.group_buffers(grads, layout)[0]
    sq = torch.sum(torch.stack([ops.sq_norm(g, impl=impl) for g in gb]))
    gnorm = torch.sqrt(sq)
    if spec.clip_norm is not None:
        clip_scale = torch.clamp(spec.clip_norm / (gnorm + 1e-12), max=1.0)
    else:
        clip_scale = torch.ones_like(gnorm)
    keep = verdict(gnorm) if verdict is not None else None

    def kept(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
        return new if keep is None else torch.where(keep != 0, new, old)

    sched_state: ScaleByScheduleState = opt_state[-1]
    eta = spec.lr(sched_state.step)
    new_state = {"wd": (), "lr": ScaleByScheduleState(step=kept(sched_state.step + 1,
                                                                sched_state.step))}
    if spec.clip_norm is not None:
        new_state["clip"] = ClipState(last_norm=kept(gnorm, opt_state[0].last_norm))
    if spec.family == "sgd":
        trace = opt_state[fields.index("trace")] if spec.momentum else None
        mb = bufs(trace.momentum) if spec.momentum else [None] * len(wb)
        for w, g, m in zip(wb, gb, mb):
            ops.sgd_epilogue(w, g, m, clip_scale, eta, momentum=spec.momentum,
                             nesterov=spec.nesterov, weight_decay=spec.weight_decay,
                             keep=keep, impl=impl)
        new_state["trace"] = trace
    else:
        adam: AdamState = opt_state[fields.index("adam")]
        step = adam.step + 1
        c1 = 1.0 - spec.b1 ** step.float()
        c2 = 1.0 - spec.b2 ** step.float()
        for w, g, mu, nu in zip(wb, gb, bufs(adam.mu), bufs(adam.nu)):
            ops.adamw_epilogue(w, g, mu, nu, clip_scale, eta, c1, c2, b1=spec.b1, b2=spec.b2,
                               eps=spec.eps, weight_decay=spec.weight_decay, keep=keep,
                               impl=impl)
        new_state["adam"] = AdamState(step=kept(step, adam.step), mu=adam.mu, nu=adam.nu)
    for tree, out in gathered:         # scatter back into the per-leaf tensors
        trees.tree_copy_(tree, buckets.BucketedState(tuple(out), layout).to_tree())
    return params, tuple(new_state[f] for f in fields), gnorm


# ---------------------------------------------------------------------------
# Modeled epilogue HBM traffic (a copy of the reference's model)
# ---------------------------------------------------------------------------

def epilogue_hbm_bytes(param_count: int, param_bytes: int, *,
                       family: str = "adamw", clip: bool = True,
                       weight_decay: bool = True, momentum: bool = True,
                       carried_norm: bool = True, fused: bool,
                       resident: bool = True) -> int:
    """Modeled HBM bytes of one step's weight-space epilogue (perturb + tail).

    Enumerates the HBM passes of the reference's code paths: every per-leaf
    map pass of its per-leaf chain streams its operands and result
    (fp32 intermediates included), while the fused path reads and writes each
    tensor once per kernel. `param_bytes` is the total byte size of the
    parameter tree (grads assumed the same dtype); optimizer state is fp32.
    `carried_norm=True` models AsyncSAM, where the perturbation norm is
    carried state rather than a fresh reduction over the ascent gradient.

    The fused side models BOTH residency regimes. `resident=True` counts
    kernel-streamed bytes only — training state lives as persistent dtype
    buckets (`buckets.BucketedState`) that the kernels consume and donate
    directly, so no conversion copies exist; this is the number the
    reference's `benchmarks/perf_cell.py` holds its traced traffic to. The
    model leaves out AsyncSAM's ascent refresh (`fused_dot_norms`, a read of
    both fp32 ascent buffers) in the resident regime, and with clip=False
    the grad-norm pass that `fused_apply` runs every step for the grad_norm
    metric.
    `resident=False` models the gather/scatter-per-call regime: each kernel
    call re-gathers its operand buckets from the pytree (concatenate) and
    scatters results back (slice), each conversion costing read + write of
    its payload — which is why the fused kernels alone never realized their
    reduction before bucketed state persisted across steps. (The ascent-grad
    gather is approximated at param dtype, matching the perturb terms.)
    """
    P = param_bytes               # one full pass over params/grads
    F = 4 * param_count           # one full pass over an fp32 state tree
    total = 0
    if fused:
        if not carried_norm:
            total += P                      # sq_norm kernel: read g
        total += 3 * P                      # perturb axpy: read w,g / write w_hat
        if clip:
            total += P                      # clip sq_norm kernel: read g
        if family == "adamw":
            total += 2 * P + 2 * F          # epilogue read: w, g, mu, nu
            total += P + 2 * F              # epilogue write: w', mu', nu'
        else:
            total += 2 * P                  # epilogue read: w, g
            total += P                      # epilogue write: w'
            if momentum:
                total += 2 * F              # read m / write m'
        if not resident:
            # per-call bucket conversions: gather = read tree + write buffer,
            # scatter = read buffer + write tree (2x payload each)
            total += 2 * 3 * P              # perturb: gather g,w / scatter w_hat
            if not carried_norm:
                total += 2 * P              # fresh-norm sq_norm: gather g
            else:
                total += 2 * 2 * F          # ascent refresh dot_norms: gather
                                            # a_t, a_{t-1} (fp32 carried state)
            total += 2 * 3 * P              # apply: gather w,g / scatter w'
            if family == "adamw":
                total += 2 * 4 * F          # gather mu,nu / scatter mu',nu'
            elif momentum:
                total += 2 * 2 * F          # gather m / scatter m'
        return total
    # per-leaf path, pass by pass
    if not carried_norm:
        total += P                          # global_norm: read g
    total += 3 * P                          # perturb map: read w,g / write w_hat
    if clip:
        total += P                          # global_norm: read g
        total += P + F                      # scale map: read g / write f32
        total += F + P                      # cast-back map: read f32 / write g
    if family == "adamw":
        total += F + P + F                  # mu map: read mu,g / write mu'
        total += F + P + F                  # nu map: read nu,g / write nu'
        total += 2 * F + P                  # update map: read mu',nu' / write u
        if weight_decay:
            total += 3 * P                  # wd map: read u,w / write u'
    else:
        if weight_decay:
            total += 3 * P                  # wd map: read g,w / write g'
        if momentum:
            total += P + F + F + P          # trace map: read g,m / write m',out
    total += P + F                          # lr map: read u / write f32
    total += P + F + P                      # apply map: read w,u / write w'
    return total
