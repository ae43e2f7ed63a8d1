"""Flash-attention forward: the Hopper kernel and its wrapper (counterpart of
`repro.kernels.flash_attention`).

The kernel (`csrc/flash_attention.cu`, CUDA C++ for sm_90a) replaces the
Pallas TPU kernel `_fa_kernel`; its source says what bounds it on the H100
and how its design differs from the TPU's. It has two paths, and
`kernel_path` (a plain function of dtype, head dims, strides and base
alignment) names the one a call takes:
  "wgmma"       bf16 q/k/v with head dims that are multiples of 16 and bases
                and strides that TMA can read (16-byte aligned, positive
                multiples of 16 bytes): every call of the model paths. TMA
                loads into a ring of K/V tiles, Q K^T and P V as wgmma, the
                scores, probabilities and output accumulator in registers;
  "cuda_cores"  everything else (fp32, head dims that are not multiples of
                16, unaligned or broadcast views): fp32 FMAs.
The C entry refuses a path that the inputs do not satisfy. The kernel is
built with nvcc at the first launch and bound through ctypes, so importing
this module needs neither nvcc nor a card.

`flash_attention` takes q (B,Sq,H,hd) and k/v (B,Sk,K,hd[_v]) in the model's
layout, and `q_offset`, the position of query row 0 (a sequence-parallel
rank's block of queries against the whole sequence's keys: row i sees keys
up to q_offset + i under the causal mask, and those with q_offset + i - j <
window). A tensor on the CPU goes to the plain version
(`ref.flash_attention_plain`); a CUDA tensor launches the kernel or raises.
`launches` counts the kernel's launches.

The launch is the `torch.library` custom op `repro_torch::flash_attention_fwd`:
its real implementation is the ctypes launch above (it alone reads data
pointers and counts), its fake implementation gives the output's shape, so
the dry run traces the kernel on fake tensors (`utils.abstract`), and its
flop formula for `FlopCounterMode` counts 2 (hd + hd_v) operations a visible
(query, key) pair and head (`visible_pairs`).

Gradients: on the card the call is a `torch.autograd.Function` whose forward
is the kernel and whose backward is autograd of the plain version,
recomputed from the saved q, k and v. The reference has no backward kernel
either (its Pallas kernel defines no VJP; it differentiates the jnp oracle),
so the gradients are the plain version's. A backward kernel is speed work
(ROADMAP queue 1, speed and tooling). The forward kernel still runs on every
forward pass, and a failing launch still raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, flat, ref

SOURCE = build.CSRC / "flash_attention.cu"
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PATHS = {"cuda_cores": 0, "wgmma": 1}

launches = 0          # kernel launches since the last reset (plain int)
_lib = None


def _library() -> ctypes.CDLL:
    """The built kernel library, with its C signature declared (once)."""
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        lib.fa_fwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                               + [ctypes.c_int64] * 12
                               + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p])
        lib.fa_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def kernel_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel's path for these inputs: "wgmma" for bf16 q/k/v whose head
    dims are multiples of 16, whose base addresses are 16-byte aligned and
    whose batch, sequence and head strides are positive multiples of 8
    elements (what TMA reads); "cuda_cores" otherwise. Reads only dtypes,
    shapes, strides and data pointers: launches nothing, needs no card."""
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        return "cuda_cores"
    if q.shape[-1] % 16 or v.shape[-1] % 16:
        return "cuda_cores"
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(s <= 0 or s % 8 for s in t.stride()[:3]):
            return "cuda_cores"
    return "wgmma"


def uses_tensor_cores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether these inputs take the tensor-core (wgmma) path."""
    return kernel_path(q, k, v) == "wgmma"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int], q_offset: int = 0) -> None:
    if not (flat.on_kernel_device(q) and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention kernel needs q, k, v on one CUDA device; "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 q/k/v of "
                        f"one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention expects q (B,Sq,H,hd), k/v (B,Sk,K,hd)")
    b, sq, h, hd = q.shape
    _, sk, n_kv, _ = k.shape
    if (k.shape[0] != b or k.shape[3] != hd or v.shape[:3] != k.shape[:3]
            or min(sq, sk, n_kv) < 1 or h % n_kv != 0):
        raise ValueError(f"incompatible shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if hd > MAX_HEAD_DIM or v.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"head dims {hd}/{v.shape[3]} exceed {MAX_HEAD_DIM}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs a contiguous last dim")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: Optional[int], q_offset: int = 0) -> torch.Tensor:
    """The kernel (its op) on checked inputs; returns (B,Sq,H,hd_v)."""
    return torch.ops.repro_torch.flash_attention_fwd(q, k, v, causal, window or 0, q_offset)


def _launch_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                 window: int, q_offset: int) -> torch.Tensor:
    """One kernel launch on checked inputs (window 0: none): the op's CUDA
    kernel (`_launch_fake` gives the output's shape on fake tensors)."""
    global launches
    b, sq, h, hd = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    hd_v = v.shape[3]
    out = torch.empty((b, sq, h, hd_v), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _library().fa_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                       _DTYPES[q.dtype], _PATHS[kernel_path(q, k, v)],
                       b, sq, sk, h, n_kv, hd, hd_v,
                       q.stride(0), q.stride(1), q.stride(2),
                       k.stride(0), k.stride(1), k.stride(2),
                       v.stride(0), v.stride(1), v.stride(2),
                       out.stride(0), out.stride(1), out.stride(2),
                       1.0 / math.sqrt(hd), int(causal), int(window), int(q_offset), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def _launch_fake(q, k, v, causal, window, q_offset):
    return q.new_empty((*q.shape[:3], v.shape[3]))


flat.kernel_op("flash_attention_fwd",
               "(Tensor q, Tensor k, Tensor v, bool causal, int window, int q_offset) -> Tensor",
               _launch_impl, _launch_fake)


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _flops(q_shape, k_shape, v_shape, causal, window, q_offset, out_shape=None,
           **kwargs) -> int:
    """2 (hd + hd_v) operations a visible (query, key) pair and head: the
    pair count `visible_pairs` gives, as the kernel's bound counts it."""
    b, sq, h, hd = q_shape
    return 2 * (hd + v_shape[3]) * b * h * visible_pairs(sq, k_shape[1], causal, window or None,
                                                          q_offset)


def visible_pairs(sq: int, sk: int, causal: bool, window: Optional[int],
                  q_offset: int = 0) -> int:
    """(query, key) pairs the mask lets through, query i at position
    q_offset + i and keys at 0..sk-1: the work an input needs, in closed
    form. Query i sees keys [max(0, p - window + 1), min(sk, p + 1)) at p =
    q_offset + i (causal) or up to sk."""
    def upto(n: int) -> int:               # sum over j = 1..n of min(sk, j)
        n = max(0, n)
        m = min(n, sk)
        return m * (m + 1) // 2 + (n - m) * sk

    o = q_offset
    seen = upto(o + sq) - upto(o) if causal else sq * sk
    return seen - (upto(o + sq - window) - upto(o - window) if window else 0)


class FlashAttention(torch.autograd.Function):
    """Forward: the kernel. Backward: autograd of `ref.flash_attention_plain`
    recomputed from the saved inputs (no backward kernel: the reference has
    none either; one is speed work, ROADMAP queue 1)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int], q_offset: int = 0):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        return _launch(q, k, v, causal, window, q_offset)

    @staticmethod
    def backward(ctx, d_out):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ref.flash_attention_plain(*inputs, causal=ctx.causal, window=ctx.window,
                                            q_offset=ctx.q_offset)
            dq, dk, dv = torch.autograd.grad(out, inputs, d_out)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Blocked attention, query row i at position q_offset + i; returns
    (B,Sq,H,hd_v) in q's dtype."""
    if flat.takes_plain(q):
        return ref.flash_attention_plain(q, k, v, causal=causal, window=window,
                                         q_offset=q_offset)
    _check(q, k, v, window, q_offset)
    return FlashAttention.apply(q, k, v, causal, window, q_offset)
