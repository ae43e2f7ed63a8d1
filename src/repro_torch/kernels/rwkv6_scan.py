"""The RWKV6 wkv scan: its Hopper kernels and their wrapper (counterpart of
`repro.kernels.rwkv6_scan`).

The kernels (`csrc/rwkv6_scan.cu`, CUDA C++ for sm_90a) replace the Pallas
TPU kernel `_wkv_kernel`; the source says what bounds them on the H100 and
how the backward gets S_{t-1} without dividing by the decay:

  rwkv6_scan_fwd  y (B,S,H,V) in r's dtype and the final state (B,H,K,V) in
                  fp32, from an optional initial state, any S >= 1
  rwkv6_scan_bwd  dr, dk, dv (their inputs' dtypes), dw, du (summed over B
                  and S), d init_state (fp32), from the cotangents of y and
                  of the final state: what `jax.grad` of the oracle
                  `ref.rwkv6_scan_ref` gives (the TPU kernel has none)

`rwkv6_scan` takes r, k, w (B,S,H,K), v (B,S,H,V) (r, k, v one dtype,
fp32 or bf16; w the log decay in fp32), u (H,K) fp32, K and V up to
`MAX_DIM`; a strided view (a rank's heads of a whole tensor) is taken
too, made contiguous first. A tensor on the CPU goes to the plain version
(`ref.rwkv6_scan_plain`, differentiated by autograd); a CUDA tensor goes
through `RWKV6Scan`, a `torch.autograd.Function` whose forward launches the
forward kernel (saving only its inputs) and whose backward launches the
backward kernel, or raises. Both are built with nvcc at the first launch and
bound through ctypes, so importing this module needs neither nvcc nor a
card. `launches[name]` counts each kernel's launches. Each launch is a
`torch.library` custom op (`repro_torch::rwkv6_scan_fwd` / `_bwd`): the real
implementation is the launch, the fake one gives the outputs' shapes (the
dry run, `utils.abstract`), and a flop formula counts RWKV_FWD_OPS /
RWKV_BWD_OPS a state element and step.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, flat, ref

SOURCE = build.CSRC / "rwkv6_scan.cu"
MAX_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"rwkv6_scan_fwd": 0, "rwkv6_scan_bwd": 0}    # since the last reset
_lib = None


def _library() -> ctypes.CDLL:
    """The built kernel library, with its C signatures declared (once)."""
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        dims = [ctypes.c_int] * 6 + [ctypes.c_void_p]           # dtype, B, S, H, K, V, stream
        lib.rwkv6_fwd.argtypes = [ctypes.c_void_p] * 8 + dims
        lib.rwkv6_bwd.argtypes = [ctypes.c_void_p] * 15 + dims
        lib.rwkv6_fwd.restype = lib.rwkv6_bwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
           u: torch.Tensor, init_state: Optional[torch.Tensor]) -> None:
    named = {"r": r, "k": k, "v": v, "w": w, "u": u}
    if init_state is not None:
        named["init_state"] = init_state
    if not all(flat.on_kernel_device(t) and t.device == r.device for t in named.values()):
        raise ValueError(f"rwkv6 kernel needs every operand on one CUDA device; got "
                         f"{ {n: str(t.device) for n, t in named.items()} }")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv6 kernel takes float32 or bfloat16 r/k/v of one dtype; got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    fp32 = {n: t for n, t in named.items() if n in ("w", "u", "init_state")}
    if any(t.dtype != torch.float32 for t in fp32.values()):
        raise TypeError(f"rwkv6 kernel takes w, u and init_state in float32; got "
                        f"{ {n: t.dtype for n, t in fp32.items()} }")
    if r.dim() != 4:
        raise ValueError(f"rwkv6 expects r,k,w (B,S,H,K), v (B,S,H,V); got r {tuple(r.shape)}")
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    if (k.shape != r.shape or w.shape != r.shape or v.shape != (b, s, h, dv)
            or u.shape != (h, dk) or min(b, s, h, dk, dv) < 1):
        raise ValueError(f"incompatible shapes r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, w {tuple(w.shape)}, u {tuple(u.shape)}")
    if init_state is not None and init_state.shape != (b, h, dk, dv):
        raise ValueError(f"init_state must be {(b, h, dk, dv)}, got {tuple(init_state.shape)}")
    if dk > MAX_DIM or dv > MAX_DIM:
        raise ValueError(f"rwkv6 kernel takes K and V up to {MAX_DIM}, got {dk} and {dv}")
    if not all(t.is_contiguous() for t in named.values()):
        raise ValueError("rwkv6 kernel needs contiguous operands")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _fwd_impl(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor, init_state: Optional[torch.Tensor]
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One forward launch on checked inputs: (y, final state); the op's
    CUDA kernel (the fake below gives the outputs' shapes)."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    y = torch.empty((b, s, h, dv), dtype=r.dtype, device=r.device)
    state = torch.empty((b, h, dk, dv), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        rc = _library().rwkv6_fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                                  u.data_ptr(), _ptr(init_state), y.data_ptr(),
                                  state.data_ptr(), _DTYPES[r.dtype], b, s, h, dk, dv,
                                  _stream(r.device))
    if rc != 0:
        raise RuntimeError(f"rwkv6_scan_fwd kernel launch failed: CUDA error {rc}")
    launches["rwkv6_scan_fwd"] += 1
    return y, state


def _fwd_fake(r, k, v, w, u, init_state):
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    return r.new_empty((b, s, h, dv)), r.new_empty((b, h, dk, dv), dtype=torch.float32)


def _bwd_impl(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor, init_state: Optional[torch.Tensor], dy: Optional[torch.Tensor],
              d_state: Optional[torch.Tensor]) -> tuple[torch.Tensor, ...]:
    """One backward launch on checked inputs; dy / d_state may be None
    (zero). Returns (dr, dk, dv, dw, du, d_init_state); the op's CUDA
    kernel, as the forward's."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    grads = [torch.empty_like(t) for t in (r, k, v)]
    dw = torch.empty_like(w)
    du_part = torch.empty((b, h, dk), dtype=torch.float32, device=r.device)
    du = torch.empty((h, dk), dtype=torch.float32, device=r.device)
    ds0 = torch.empty((b, h, dk, dv), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        rc = _library().rwkv6_bwd(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                                  u.data_ptr(), _ptr(init_state), _ptr(dy), _ptr(d_state),
                                  *(g.data_ptr() for g in grads), dw.data_ptr(),
                                  du_part.data_ptr(), du.data_ptr(), ds0.data_ptr(),
                                  _DTYPES[r.dtype], b, s, h, dk, dv, _stream(r.device))
    if rc != 0:
        raise RuntimeError(f"rwkv6_scan_bwd kernel launch failed: CUDA error {rc}")
    launches["rwkv6_scan_bwd"] += 1
    return (*grads, dw, du, ds0)


def _bwd_fake(r, k, v, w, u, init_state, dy, d_state):
    b, s, h, dk = r.shape
    return (torch.empty_like(r), torch.empty_like(k), torch.empty_like(v),
            torch.empty_like(w), u.new_empty((h, dk), dtype=torch.float32),
            r.new_empty((b, h, dk, v.shape[-1]), dtype=torch.float32))


_ARGS = "Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor? init_state"
flat.kernel_op("rwkv6_scan_fwd", f"({_ARGS}) -> (Tensor, Tensor)", _fwd_impl, _fwd_fake)
flat.kernel_op("rwkv6_scan_bwd", f"({_ARGS}, Tensor? dy, Tensor? d_state) -> "
               "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)", _bwd_impl, _bwd_fake)


def _scan_flops(ops: int, r_shape, v_shape) -> int:
    """`ops` fp32 operations a state element and step (RWKV_FWD_OPS /
    RWKV_BWD_OPS): what the function needs, as the kernels' bounds count."""
    b, s, h, dk = r_shape
    return ops * b * s * h * dk * v_shape[-1]


# fp32 ops per state element and step that the function needs. Forward: the
# y product-add and the decay multiply-add of k v (5). Backward (12), with S
# rebuilt from the initial state: S's recurrence (3), p = S dy (2), one G
# recurrence (3), G v and G^T k (2 + 2); dw comes through q at O(K) a step.
RWKV_FWD_OPS, RWKV_BWD_OPS = 5, 12


@register_flop_formula(torch.ops.repro_torch.rwkv6_scan_fwd)
def _fwd_flops(r_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    return _scan_flops(RWKV_FWD_OPS, r_shape, v_shape)


@register_flop_formula(torch.ops.repro_torch.rwkv6_scan_bwd)
def _bwd_flops(r_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    return _scan_flops(RWKV_BWD_OPS, r_shape, v_shape)


def _launch_fwd(r, k, v, w, u, init_state) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel (its op) on checked inputs: (y, final state)."""
    return torch.ops.repro_torch.rwkv6_scan_fwd(r, k, v, w, u, init_state)


def _launch_bwd(r, k, v, w, u, init_state, dy, d_state) -> tuple[torch.Tensor, ...]:
    """The backward kernel (its op) on checked inputs: (dr, dk, dv, dw, du,
    d_init_state)."""
    return tuple(torch.ops.repro_torch.rwkv6_scan_bwd(r, k, v, w, u, init_state, dy, d_state))


class RWKV6Scan(torch.autograd.Function):
    """Forward: the forward kernel. Backward: the backward kernel, from the
    saved inputs (the forward saves nothing else: the backward rebuilds the
    states it needs)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, init_state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, init_state)
        return _launch_fwd(r, k, v, w, u, init_state)

    @staticmethod
    def backward(ctx, dy, d_state):
        r, k, v, w, u, init_state = ctx.saved_tensors
        dy = None if dy is None else dy.contiguous()
        d_state = None if d_state is None else d_state.contiguous()
        dr, dk, dv, dw, du, ds0 = _launch_bwd(r, k, v, w, u, init_state, dy, d_state)
        return dr, dk, dv, dw, du, (None if init_state is None else ds0)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
               u: torch.Tensor, init_state: Optional[torch.Tensor] = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 wkv recurrence; returns (y (B,S,H,V) in r's dtype, final state
    (B,H,K,V) fp32)."""
    if flat.takes_plain(r):
        return ref.rwkv6_scan_plain(r, k, v, w, u, init_state=init_state)
    r, k, v, w, u = (t.contiguous() for t in (r, k, v, w, u))
    init_state = None if init_state is None else init_state.contiguous()
    _check(r, k, v, w, u, init_state)
    return RWKV6Scan.apply(r, k, v, w, u, init_state)
