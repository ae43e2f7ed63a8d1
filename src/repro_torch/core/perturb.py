"""Normalized model perturbation, the primitive of the SAM family
(counterpart of `repro.core.perturb`).

`perturb(params, grad, rho)` computes  w + rho * g / ||g||  (paper Eq. 1-3).
On the fused path (bucket-resident params always, per-leaf params when
`utils.buckets.fused_path_enabled(fused)`: unless `fused` is False) it runs
on flat buckets: given the norm (AsyncSAM carries it), one `fused_axpy`
kernel per bucket with the scale
rho / (||g|| + eps); otherwise the reference's two-kernel design
(`repro/kernels/sam_perturb.py`): one `sq_norm` pass, or the squared norm the
caller already has, then one `sam_perturb` kernel per bucket. A per-leaf
tree is gathered into buckets for the call and the result cut back into
leaves. With `fused=False` and per-leaf params it is the reference's
per-leaf composition.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch

from repro_torch.utils import buckets, trees

Tree = Any
_EPS = 1e-12


def on_fused_path(params: Tree, fused: Optional[bool]) -> bool:
    """Whether a step on `params` takes the flat-buffer kernels: resident
    state always, per-leaf state as `buckets.fused_path_enabled(fused)`
    says (unless `fused` is False)."""
    return buckets.is_bucketed(params) or buckets.fused_path_enabled(fused)


def grad_sq_norm(grad: Tree, fused: bool) -> torch.Tensor:
    """||g||^2 as a device scalar: one `sq_norm` kernel per bucket on the
    fused path (a per-leaf tree gathered into buckets for the call), the
    reference's per-leaf sum otherwise."""
    return buckets.bucketed_sq_norm(grad) if fused else trees.tree_sq_norm(grad)


def perturbation_scale(grad: Tree, rho: Union[float, torch.Tensor],
                       grad_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scalar rho/||g|| with a zero-safe denominator."""
    if grad_norm is None:
        grad_norm = trees.global_norm(grad)
    return rho / (grad_norm + _EPS)


def perturb(params: Tree, grad: Tree, rho: Union[float, torch.Tensor],
            grad_norm: Optional[torch.Tensor] = None, *,
            sq_norm: Optional[torch.Tensor] = None, fused: Optional[bool] = None,
            out: Optional[Tree] = None) -> Tree:
    """w + rho * g/||g|| in the params' dtypes, into `out` when given.

    `grad_norm` (a device scalar) skips the norm pass: AsyncSAM carries it.
    `sq_norm`, the squared norm, does the same for the `sam_perturb` kernel.
    `fused` False keeps per-leaf params on the per-leaf path.
    """
    resident = buckets.is_bucketed(params)
    if resident or buckets.fused_path_enabled(fused):
        layout = params.layout if resident else buckets.bucket_layout(params)
        into = out if resident else None
        if grad_norm is not None:
            res = buckets.bucketed_axpy(rho / (grad_norm + _EPS), grad, params, out=into,
                                        layout=layout)
        else:
            if sq_norm is None:
                sq_norm = buckets.bucketed_sq_norm(grad, layout)
            res = buckets.bucketed_sam_perturb(params, grad, rho, sq_norm, out=into,
                                               layout=layout)
        if resident:
            return res
    else:
        if grad_norm is None and sq_norm is not None:
            grad_norm = torch.sqrt(sq_norm)
        scale = perturbation_scale(grad, rho, grad_norm)
        res = trees.tree_map(lambda p, g: (p.float() + scale * g.float()).to(p.dtype),
                             params, grad)
    return res if out is None else trees.tree_copy_(out, res)


def perturb_masked(params: Tree, grad: Tree, rho: Union[float, torch.Tensor], mask: Tree, *,
                   fused: Optional[bool] = None) -> Tree:
    """ESAM-style partial perturbation: only the elements where mask == 1.

    The norm is taken over the masked gradient, so the realized perturbation
    radius stays rho."""
    masked = trees.tree_map(lambda g, m: g * m, grad, mask)
    return perturb(params, masked, rho, fused=fused)


def gradient_norm_penalty_direction(grad_w: Tree, grad_pert: Tree, alpha: float, *,
                                    out: Optional[Tree] = None) -> Tree:
    """Generalized-SAM mixing (1-alpha) ∇L(w) + alpha ∇L(ŵ) (Zhao et al. 22),
    in fp32 and cast to the gradients' dtypes, on buckets or per-leaf trees
    alike; into `out` when given (`grad_pert` itself may be `out`: an fp32
    pair is mixed in place, with no fp32 temporaries)."""
    def mix(gw, gp, o=None):
        if gw.dtype == gp.dtype == torch.float32:
            return torch.mul(gp, alpha, out=o).add_(gw, alpha=1.0 - alpha)
        res = ((1.0 - alpha) * gw.float() + alpha * gp.float()).to(gw.dtype)
        return res if o is None else o.copy_(res)

    with torch.no_grad():
        if out is None:
            return trees.tree_map(mix, grad_w, grad_pert)
        return trees.tree_map(mix, grad_w, grad_pert, out)
