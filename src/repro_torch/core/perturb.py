"""Normalized model perturbation, the primitive of the SAM family
(counterpart of `repro.core.perturb`).

`perturb(params, grad, rho)` computes  w + rho * g / ||g||  (paper Eq. 1-3) on
the bucketed path: one `sq_norm` kernel per bucket when the norm is not
given, then one `fused_axpy` kernel per bucket, buffer to buffer.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.utils import buckets

_EPS = 1e-12


def perturb(params: buckets.BucketedState, grad: buckets.BucketedState,
            rho: Union[float, torch.Tensor], grad_norm: Optional[torch.Tensor] = None, *,
            out: Optional[buckets.BucketedState] = None) -> buckets.BucketedState:
    """w + rho * g/||g|| in the params' dtypes, into `out` when given.

    `grad_norm` (a device scalar) skips the norm pass: AsyncSAM carries it.
    """
    if not buckets.is_bucketed(params):
        raise TypeError("perturb takes bucket-resident params (utils.buckets.BucketedState)")
    if grad_norm is None:
        grad_norm = torch.sqrt(buckets.bucketed_sq_norm(grad, params.layout))
    scale = rho / (grad_norm + _EPS)
    return buckets.bucketed_axpy(scale, grad, params, out=out, layout=params.layout)
