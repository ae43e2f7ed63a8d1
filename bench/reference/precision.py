"""Matrix products in a precision below the configuration's, for the
control of the correctness check: the reference computed as a program that
cut its precision would compute it.

`fp8_mm` rounds both operands to float8 e4m3 under a per-tensor scale that
is a power of two (so the rounded values, and their products, are exact in
bfloat16), multiplies them in bfloat16 with float32 accumulation (the
tensor cores' fp8 product) and returns float32. `bf16_mm` rounds the
operands to bfloat16 alike.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = torch.exp2(torch.floor(torch.log2(E4M3_MAX / amax)))
    q = (t * scale).to(torch.float8_e4m3fn)
    return q.to(torch.bfloat16) / scale.to(torch.bfloat16)


def _round(t: torch.Tensor, kind: str) -> torch.Tensor:
    return _fp8(t) if kind == "fp8" else t.to(torch.bfloat16)


class _LowMatMul(torch.autograd.Function):
    """a @ b with both operands rounded to `kind`, and the two products of
    its backward (g @ b^T, a^T @ g) rounded alike."""

    @staticmethod
    def forward(ctx, a, b, kind):
        ctx.save_for_backward(a, b)
        ctx.kind = kind
        return torch.matmul(_round(a, kind), _round(b, kind)).float()

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        k = ctx.kind
        rg = _round(g, k)
        ga = torch.matmul(rg, _round(b, k).transpose(-1, -2)).float()
        gb = torch.matmul(_round(a, k).transpose(-1, -2), rg).float()
        # broadcast dims of a weight (2-D) against batched activations
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        while ga.dim() > a.dim():
            ga = ga.sum(0)
        return ga, gb, None


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _LowMatMul.apply(a, b, "fp8")


def bf16_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _LowMatMul.apply(a, b, "bf16")


MATMULS = {"fp8": fp8_mm, "bf16": bf16_mm}
