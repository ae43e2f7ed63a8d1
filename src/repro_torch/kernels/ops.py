"""Kernel dispatch layer (counterpart of `repro.kernels.ops`).

Models call these entry points only. By default a CUDA tensor goes to the
Hopper kernel and a CPU tensor to the plain version (the kernel wrappers
decide that by the tensor's device). `impl="plain"` forces the plain PyTorch
version on any device; `impl="kernel"` is the default. `set_default_impl` is
the test hook that changes the default for every call, as the reference's
does, so a whole model can run through the plain versions on the card.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flat
from repro_torch.kernels import fused_update as fu
from repro_torch.kernels import mamba2_scan as m2
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_scan as r6
from repro_torch.kernels import sam_perturb as sp

IMPLS = ("kernel", "plain")
_FORCED_IMPL: Optional[str] = None  # test hook: "kernel" | "plain"


def mixer_launches(family: str, backward: bool = False) -> dict[str, int]:
    """Launches since the last reset of the kernels of a family's sequence
    mixer: flash attention (dense), the rwkv6 wkv scan (ssm), flash attention
    and the Mamba2 SSD scan (hybrid); the scans' backward when `backward`
    (training)."""
    if family == "ssm":
        names = ("rwkv6_scan_fwd", "rwkv6_scan_bwd") if backward else ("rwkv6_scan_fwd",)
        return {name: r6.launches[name] for name in names}
    if family == "hybrid":
        names = ("mamba2_scan_fwd", "mamba2_scan_bwd") if backward else ("mamba2_scan_fwd",)
        return {"flash_attention": fa.launches, **{name: m2.launches[name] for name in names}}
    return {"flash_attention": fa.launches}


def set_default_impl(impl: Optional[str]) -> None:
    global _FORCED_IMPL
    if impl is not None and impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS} or None, got {impl!r}")
    _FORCED_IMPL = impl


def _resolve(impl: Optional[str]) -> str:
    mode = impl or _FORCED_IMPL or "kernel"
    if mode not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {mode!r}")
    return mode


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Blocked attention. q (B,Sq,H,hd); k/v (B,Sk,K,hd) with GQA K<=H;
    query row i at position q_offset + i."""
    if _resolve(impl) == "plain":
        return ref.flash_attention_plain(q, k, v, causal=causal, window=window,
                                         q_offset=q_offset)
    return fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: Union[int, torch.Tensor], *,
                     window: Optional[int] = None,
                     impl: Optional[str] = None) -> torch.Tensor:
    """Attention of new positions over a KV cache.

    The plain version on every device, as in the reference (its TPU path is
    jnp too), so it has no kernel to port.
    """
    _resolve(impl)
    return ref.decode_attention_plain(q, k, v, valid_len, window=window)


def rwkv6_mix(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor, *, init_state: Optional[torch.Tensor] = None,
              impl: Optional[str] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 wkv recurrence. Returns (y, final_state).

    Unlike the reference, which falls back to its oracle when `init_state`
    is given or S is not a multiple of its chunk, the kernel takes both: a
    decode step is a one-token scan from the carried state."""
    if _resolve(impl) == "plain":
        return ref.rwkv6_scan_plain(r, k, v, w, u, init_state=init_state)
    return r6.rwkv6_scan(r, k, v, w, u, init_state=init_state)


def mamba2_mix(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, d: torch.Tensor, *, chunk: int = 128,
               init_state: Optional[torch.Tensor] = None,
               impl: Optional[str] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba2/SSD sequence mixing. Returns (y, final_state).

    Unlike the reference, which falls back to its oracle when `init_state`
    is given or S is not a multiple of `chunk`, the kernel takes both."""
    if _resolve(impl) == "plain":
        return ref.mamba2_chunked_plain(x, dt, a, b, c, d, chunk=chunk, init_state=init_state)
    return m2.mamba2_scan(x, dt, a, b, c, d, init_state=init_state, chunk=chunk)


def mamba2_decode_step(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, d: torch.Tensor, state: torch.Tensor, *,
                       impl: Optional[str] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD update (serving): state (B,H,P,N). The reference runs
    its sequential oracle; on the card the port runs the kernel, a one-token
    scan from the carried state."""
    if _resolve(impl) == "plain":
        return ref.mamba2_scan_plain(x, dt, a, b, c, d, init_state=state)
    return m2.mamba2_scan(x, dt, a, b, c, d, init_state=state)


def sq_norm(g_flat: torch.Tensor, *, impl: Optional[str] = None) -> torch.Tensor:
    """Sum of squares of a flat vector (fp32 chunk partials on the card)."""
    if _resolve(impl) == "plain":
        return ref.sq_norm_plain(g_flat)
    return sp.sq_norm(g_flat)


def sam_perturb(w_flat: torch.Tensor, g_flat: torch.Tensor, rho, sq_norm, *,
                out: Optional[torch.Tensor] = None,
                impl: Optional[str] = None) -> torch.Tensor:
    """Fused  w + rho * g / ||g||  over flat vectors (w's dtype out), into
    `out` when given."""
    if _resolve(impl) == "plain":
        return flat.sam_perturb_plain(w_flat, g_flat, rho, sq_norm, out)
    return sp.sam_perturb(w_flat, g_flat, rho, sq_norm, out=out)


def fused_axpy(alpha, x_flat: torch.Tensor, y_flat: torch.Tensor, *,
               out: Optional[torch.Tensor] = None,
               impl: Optional[str] = None) -> torch.Tensor:
    """Single-pass  y + alpha * x  over flat vectors (y's dtype out), into
    `out` when given."""
    if _resolve(impl) == "plain":
        return flat.axpy_plain(alpha, x_flat, y_flat, out)
    return fu.fused_axpy(alpha, x_flat, y_flat, out=out)


def fused_dot_norms(a_flat: torch.Tensor, b_flat: torch.Tensor, *,
                    impl: Optional[str] = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(<a,b>, ||a||^2, ||b||^2) in one pass over (a, b)."""
    if _resolve(impl) == "plain":
        return ref.dot_norms_flat_plain(a_flat, b_flat)
    return fu.fused_dot_norms(a_flat, b_flat)


def adamw_epilogue(w_flat: torch.Tensor, g_flat: torch.Tensor, mu_flat: torch.Tensor,
                   nu_flat: torch.Tensor, clip_scale, lr, c1, c2, *,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   weight_decay: float = 0.0, keep=None, impl: Optional[str] = None):
    """Fused clip-adam-wd-lr-apply (AdamW family). Updates w, mu and nu in
    place and returns (w', mu', nu'), the same tensors; `keep` 0 (the numerics
    guard's skip) leaves them as they were."""
    plain = _resolve(impl) == "plain"
    epilogue = flat.adamw_epilogue_plain_ if plain else fu.adamw_epilogue
    return epilogue(w_flat, g_flat, mu_flat, nu_flat, clip_scale, lr, c1, c2,
                    b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, keep=keep)


def sgd_epilogue(w_flat: torch.Tensor, g_flat: torch.Tensor, m_flat: Optional[torch.Tensor],
                 clip_scale, lr, *, momentum: float = 0.0, nesterov: bool = False,
                 weight_decay: float = 0.0, keep=None, impl: Optional[str] = None):
    """Fused clip-wd-momentum-lr-apply (SGD family). Updates w (and m) in
    place and returns (w', m'-or-None), the same tensors; `keep` 0 (the
    numerics guard's skip) leaves them as they were."""
    plain = _resolve(impl) == "plain"
    epilogue = flat.sgd_epilogue_plain_ if plain else fu.sgd_epilogue
    return epilogue(w_flat, g_flat, m_flat, clip_scale, lr, momentum=momentum,
                    nesterov=nesterov, weight_decay=weight_decay, keep=keep)


def delta_amax(p_flat: torch.Tensor, s_flat: torch.Tensor, e_flat: torch.Tensor, *,
               impl: Optional[str] = None) -> torch.Tensor:
    """max |p - s + e| over flat buckets (the JOB-delta int8 scale probe)."""
    if _resolve(impl) == "plain":
        return ref.delta_amax_flat_plain(p_flat, s_flat, e_flat)
    return fu.delta_amax(p_flat, s_flat, e_flat)


def delta_encode_i8(p_flat: torch.Tensor, s_flat: torch.Tensor, e_flat: torch.Tensor, scale,
                    *, impl: Optional[str] = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-pass int8 delta encode: (q int8, shadow' fp32, residual' fp32), the
    shadow and residual written into s and e."""
    if _resolve(impl) == "plain":
        return flat.delta_encode_i8_plain_(p_flat, s_flat, e_flat, scale)
    return fu.delta_encode_i8(p_flat, s_flat, e_flat, scale)
