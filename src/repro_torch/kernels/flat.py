"""What the flat-buffer kernel wrappers share (`sam_perturb`, `fused_update`).

`CHUNK` is the elements per CTA, the TPU kernels' chunk (the reference's
`repro.kernels.sam_perturb.CHUNK`); the input and launch checks raise rather
than fall back. The plain routes that write into caller buffers are the ones
both the wrappers (for a CPU tensor) and `ops` (for `impl="plain"`) take.
"""
from __future__ import annotations

import contextlib
from typing import Mapping, Optional

import torch

from repro_torch.kernels import ref

CHUNK = 64 * 1024     # elements per CTA, the TPU kernels' chunk
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


_LIB = torch.library.Library("repro_torch", "FRAGMENT")


def kernel_op(name: str, schema: str, impl, fake):
    """`repro_torch::<name>`, a `torch.library` op with `schema`: `impl` (the
    kernel's launch) its CUDA kernel, `fake` its fake implementation (the
    outputs' shapes, for FakeTensorMode: the dry run). Defined with
    `torch.library.Library` rather than `custom_op`, whose Python wrappers
    cost a launch some 20 us more of host time; no autograd kernel: every
    call is made with grad off (inside a `torch.autograd.Function`'s forward
    or backward) or on buffers that need none. Returns the op."""
    _LIB.define(name + schema)
    _LIB.impl(name, impl, "CUDA")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=_LIB)
    return getattr(torch.ops.repro_torch, name)


_trace_kernels = False


@contextlib.contextmanager
def trace_kernels():
    """Within the block a fake tensor (`utils.abstract`) on the CPU takes its
    kernel's op, as a CUDA tensor does: the op's fake implementation gives
    the outputs' shapes and nothing launches. So a dry run on the CPU traces
    the card's step (its plain versions at production shapes would take
    hours: the wkv scan's is a loop over the sequence). A real CPU tensor
    still takes the plain version."""
    global _trace_kernels
    before, _trace_kernels = _trace_kernels, True
    try:
        yield
    finally:
        _trace_kernels = before


def on_kernel_device(t: torch.Tensor) -> bool:
    """Whether a wrapper given t takes its kernel: t lies on a CUDA device,
    or t is a fake tensor inside `trace_kernels`."""
    if t.is_cuda:
        return True
    if not _trace_kernels:
        return False
    from repro_torch.utils import abstract
    return abstract.is_fake(t)


def takes_plain(t: torch.Tensor) -> bool:
    """Whether a wrapper given t runs the plain version: t lies on the CPU
    and is not traced as a kernel's input."""
    return t.device.type == "cpu" and not on_kernel_device(t)


def n_chunks(n: int) -> int:
    return (n + CHUNK - 1) // CHUNK


def check_flat(kernel: str, operands: Mapping[str, torch.Tensor],
               dtypes: Optional[Mapping[str, tuple]] = None) -> torch.device:
    """Raise unless the operands are contiguous 1-D tensors of one length on
    one CUDA device, each of a dtype the kernel takes (`dtypes[name]`, by
    default float32 or bfloat16). Returns the device."""
    tensors = list(operands.values())
    dev = tensors[0].device
    if not on_kernel_device(tensors[0]) or any(t.device != dev for t in tensors):
        raise ValueError(f"{kernel} kernel needs its operands on one CUDA device; got "
                         f"{ {k: str(t.device) for k, t in operands.items()} }")
    for name, t in operands.items():
        allowed = (dtypes or {}).get(name, tuple(DTYPES))
        if t.dtype not in allowed:
            raise TypeError(f"{kernel}: {name} must be one of {allowed}, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be a contiguous 1-D buffer, got shape "
                             f"{tuple(t.shape)} strides {t.stride()}")
        if t.numel() != tensors[0].numel():
            raise ValueError(f"{kernel}: operands differ in length: "
                             f"{ {k: v.numel() for k, v in operands.items()} }")
    return dev


def check_launch(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")


def stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def axpy_plain(alpha, x: torch.Tensor, y: torch.Tensor,
               out: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain version of `fused_axpy`, written into `out` when given."""
    res = ref.axpy_flat_plain(alpha, x, y)
    return res if out is None else out.copy_(res)


def sam_perturb_plain(w: torch.Tensor, g: torch.Tensor, rho, sq_norm,
                      out: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain version of `sam_perturb`, written into `out` when given."""
    res = ref.sam_perturb_flat_plain(w, g, rho, sq_norm)
    return res if out is None else out.copy_(res)


def sgd_epilogue_plain_(w: torch.Tensor, g: torch.Tensor, m: Optional[torch.Tensor],
                        clip_scale, lr, **hyper
                        ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version of `sgd_epilogue`, written into w and (with
    momentum) m."""
    w_new, m_new = ref.sgd_epilogue_flat_plain(w, g, m, clip_scale, lr, **hyper)
    w.copy_(w_new)
    if m_new is None:
        return w, None
    return w, m.copy_(m_new)


def adamw_epilogue_plain_(w: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                          nu: torch.Tensor, clip_scale, lr, c1, c2, **hyper
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of `adamw_epilogue`, written into w, mu and nu."""
    new = ref.adamw_epilogue_flat_plain(w, g, mu, nu, clip_scale, lr, c1, c2, **hyper)
    for buf, val in zip((w, mu, nu), new):
        buf.copy_(val)
    return w, mu, nu


def delta_encode_i8_plain_(p: torch.Tensor, s: torch.Tensor, e: torch.Tensor, scale
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of `delta_encode_i8`: q in a new buffer, s' and e'
    written into s and e."""
    q, s_new, e_new = ref.delta_encode_i8_flat_plain(p, s, e, scale)
    return q, s.copy_(s_new), e.copy_(e_new)
