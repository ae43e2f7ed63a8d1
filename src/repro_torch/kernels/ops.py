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
from repro_torch.kernels import ref

IMPLS = ("kernel", "plain")
_FORCED_IMPL: Optional[str] = None  # test hook: "kernel" | "plain"


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
                    causal: bool = True, window: Optional[int] = None,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Blocked attention. q (B,Sq,H,hd); k/v (B,Sk,K,hd) with GQA K<=H."""
    if _resolve(impl) == "plain":
        return ref.flash_attention_plain(q, k, v, causal=causal, window=window)
    return fa.flash_attention(q, k, v, causal=causal, window=window)


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
