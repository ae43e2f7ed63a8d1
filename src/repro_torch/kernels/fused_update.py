"""The fused weight-space kernels of the training step and their wrappers
(counterpart of `repro.kernels.fused_update`).

The kernels (`csrc/fused_update.cu`, CUDA C++ for sm_90a) replace six
Pallas TPU kernels, each one pass over flat dtype buckets:

  fused_axpy       out = y + alpha * x          (the AsyncSAM perturbation)
  fused_dot_norms  (<a,b>, ||a||^2, ||b||^2)    (AsyncSAM ascent refresh)
  adamw_epilogue   w' = w - lr * ((mu'/c1)/(sqrt(nu'/c2)+eps) + wd*w)
  sgd_epilogue     u = clip*g (+ wd*w); m' = mu*m + u;
                   w' = w - lr * (nesterov ? mu*m' + u : m')   (no momentum:
                   w' = w - lr * u, and no m)
  delta_amax       max |p - s + e|              (int8 JOB-delta scale probe)
  delta_encode_i8  d = p - s + e; q = clip(rint(d/scale), +-127) int8;
                   s' = s + q*scale; e' = d - q*scale   (the JOB-delta encode)

Scalars that change per step (alpha; clip scale, lr, c1, c2) stay on the
device and the kernels read them there, so no call waits for the device.
The two epilogues also take `keep`, the numerics guard's verdict as a 0-d
fp32 device tensor (None: 1): at 0 the kernel writes nothing and w and the
moments stay as they were bit for bit; at 1 it computes what it computes
without it.
Where the port departs from the reference's functional form, for memory:
`fused_axpy` writes into `out` when given, `adamw_epilogue` updates w, mu
and nu in place, and `sgd_epilogue` w and m (the reference's jit donation
aliases them the same way). `delta_encode_i8` writes the advanced shadow and
residual into s and e (the reference returns new buffers; a new pair would
cost 8 bytes per parameter at every exchange), and takes the scale by value:
the encoder holds it on the host already, for the wire.

A CPU tensor goes to the plain version (`kernels.ref`); a CUDA tensor
launches the kernel or raises. Each kernel counts its launches in
`launches[name]`. Each launch is a `torch.library` custom op
(`repro_torch::<name>`; the in-place ones declare what they write) whose
fake implementation gives its outputs' shapes (the dry run,
`utils.abstract`); these bandwidth kernels register no flop formula.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, flat, ref
from repro_torch.kernels.flat import DTYPES, check_flat, check_launch, n_chunks, stream

SOURCE = build.CSRC / "fused_update.cu"
_F32 = (torch.float32,)

launches = {"fused_axpy": 0, "fused_dot_norms": 0, "adamw_epilogue": 0, "sgd_epilogue": 0,
            "delta_amax": 0, "delta_encode_i8": 0}
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
        lib.fused_axpy.argtypes = [p, p, i, p, i, p, i64, p]
        lib.fused_dot_norms.argtypes = [p, i, p, i, i64, p, p]
        lib.adamw_epilogue.argtypes = [p, i, p, i, p, p, i64, p] + [f] * 6 + [p]
        lib.sgd_epilogue.argtypes = [p, i, p, i, p, i64, p, f, i, f, p]
        lib.delta_amax.argtypes = [p, i, p, p, i64, p, p]
        lib.delta_encode_i8.argtypes = [p, i, p, p, p, i64, f, p]
        for fn in (lib.fused_axpy, lib.fused_axpy_tile, lib.fused_dot_norms,
                   lib.adamw_epilogue, lib.sgd_epilogue, lib.delta_amax, lib.delta_encode_i8):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _scalar(x, dev: torch.device) -> torch.Tensor:
    """x as a 0-dim fp32 tensor on `dev` (no copy when it already is one). A
    host number is filled in on the device (`torch.full`), not copied from
    the host: a copy would allocate a real device tensor under a
    FakeTensorMode (the dry run)."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, torch.float32).reshape(())
    return torch.full((), float(x), dtype=torch.float32, device=dev)


def fused_axpy(alpha, x: torch.Tensor, y: torch.Tensor, *,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y + alpha * x over flat vectors, y's dtype, into `out` when given."""
    if flat.takes_plain(y):
        return flat.axpy_plain(alpha, x, y, out)
    if out is None:
        out = torch.empty_like(y)
    dev = check_flat("fused_axpy", {"x": x, "y": y, "out": out}, {"out": (y.dtype,)})
    if y.numel() == 0:
        return out
    torch.ops.repro_torch.fused_axpy(_scalar(alpha, dev), x, y, out)
    return out


# Each launch below is a `torch.library` op (`flat.kernel_op`): its CUDA
# kernel is the launch on checked, non-empty operands, with the count; its
# fake gives the outputs' shapes on fake tensors, and an op that writes in
# place declares what it writes in its schema.

def _axpy_impl(a: torch.Tensor, x: torch.Tensor, y: torch.Tensor, out: torch.Tensor) -> None:
    dev = y.device
    with torch.cuda.device(dev):
        rc = _library().fused_axpy(a.data_ptr(), x.data_ptr(), DTYPES[x.dtype], y.data_ptr(),
                                   DTYPES[y.dtype], out.data_ptr(), y.numel(), stream(dev))
    check_launch("fused_axpy", rc)
    launches["fused_axpy"] += 1


def _axpy_fake(a, x, y, out):
    return None


flat.kernel_op("fused_axpy", "(Tensor a, Tensor x, Tensor y, Tensor(a!) out) -> ()",
               _axpy_impl, _axpy_fake)


def axpy_tile() -> int:
    """Elements a CTA of the fused_axpy kernel takes (its sweep's tile)."""
    return _library().fused_axpy_tile()


def fused_dot_norms(a: torch.Tensor, b: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(<a,b>, ||a||^2, ||b||^2), fp32 partials per chunk summed here."""
    if flat.takes_plain(a):
        return ref.dot_norms_flat_plain(a, b)
    dev = check_flat("fused_dot_norms", {"a": a, "b": b})
    if a.numel() == 0:
        z = torch.zeros((), dtype=torch.float32, device=dev)
        return z, z.clone(), z.clone()
    dot, sq_a, sq_b = torch.ops.repro_torch.fused_dot_norms(a, b).unbind()
    return dot, sq_a, sq_b


def _dot_norms_impl(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(<a,b>, ||a||^2, ||b||^2) as one fp32 (3,) tensor."""
    dev = a.device
    partials = torch.empty((3, n_chunks(a.numel())), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _library().fused_dot_norms(a.data_ptr(), DTYPES[a.dtype], b.data_ptr(),
                                        DTYPES[b.dtype], a.numel(), partials.data_ptr(),
                                        stream(dev))
    check_launch("fused_dot_norms", rc)
    launches["fused_dot_norms"] += 1
    return torch.sum(partials, dim=1)


def _dot_norms_fake(a, b):
    return a.new_empty((3,), dtype=torch.float32)


flat.kernel_op("fused_dot_norms", "(Tensor a, Tensor b) -> Tensor", _dot_norms_impl,
               _dot_norms_fake)


def adamw_epilogue(w: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                   clip_scale, lr, c1, c2, *, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8, weight_decay: float = 0.0, keep=None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One clip-Adam-decay-lr step; updates w, mu and nu in place and returns
    them. w fp32 or bf16, g fp32 or bf16, mu and nu fp32. `keep` 0 (the
    guard's skip) leaves all three as they were."""
    if flat.takes_plain(w):
        return flat.adamw_epilogue_plain_(w, g, mu, nu, clip_scale, lr, c1, c2, b1=b1,
                                          b2=b2, eps=eps, weight_decay=weight_decay,
                                          keep=keep)
    dev = check_flat("adamw_epilogue", {"w": w, "g": g, "mu": mu, "nu": nu},
                     {"mu": _F32, "nu": _F32})
    if w.numel() == 0:
        return w, mu, nu
    scal = torch.stack([_scalar(v, dev) for v in (clip_scale, lr, c1, c2,
                                                  1.0 if keep is None else keep)])
    torch.ops.repro_torch.adamw_epilogue(w, g, mu, nu, scal, b1, b2, eps, weight_decay)
    return w, mu, nu


def _adamw_impl(w: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                scal: torch.Tensor, b1: float, b2: float, eps: float,
                weight_decay: float) -> None:
    dev = w.device
    with torch.cuda.device(dev):
        rc = _library().adamw_epilogue(
            w.data_ptr(), DTYPES[w.dtype], g.data_ptr(), DTYPES[g.dtype], mu.data_ptr(),
            nu.data_ptr(), w.numel(), scal.data_ptr(), b1, 1.0 - b1, b2, 1.0 - b2, eps,
            weight_decay, stream(dev))
    check_launch("adamw_epilogue", rc)
    launches["adamw_epilogue"] += 1


def _adamw_fake(w, g, mu, nu, scal, b1, b2, eps, weight_decay):
    return None


flat.kernel_op("adamw_epilogue", "(Tensor(a!) w, Tensor g, Tensor(b!) mu, Tensor(c!) nu, "
               "Tensor scal, float b1, float b2, float eps, float weight_decay) -> ()",
               _adamw_impl, _adamw_fake)


def sgd_epilogue(w: torch.Tensor, g: torch.Tensor, m: Optional[torch.Tensor], clip_scale, lr,
                 *, momentum: float = 0.0, nesterov: bool = False, weight_decay: float = 0.0,
                 keep=None) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One clip-decay-momentum-lr step; updates w and (with momentum) m in
    place and returns (w, m), or (w, None) without momentum, the reference's
    (w', m'-or-None). w fp32 or bf16, g fp32 or bf16, m fp32. `keep` 0 (the
    guard's skip) leaves w and m as they were."""
    if flat.takes_plain(w):
        return flat.sgd_epilogue_plain_(w, g, m, clip_scale, lr, momentum=momentum,
                                        nesterov=nesterov, weight_decay=weight_decay,
                                        keep=keep)
    if momentum and m is None:
        raise ValueError("sgd_epilogue: momentum needs its buffer m")
    operands = {"w": w, "g": g, **({"m": m} if momentum else {})}
    dev = check_flat("sgd_epilogue", operands, {"m": _F32})
    if w.numel() == 0:
        return w, m if momentum else None
    scal = torch.stack([_scalar(clip_scale, dev), _scalar(lr, dev),
                        _scalar(1.0 if keep is None else keep, dev)])
    torch.ops.repro_torch.sgd_epilogue(w, g, m if momentum else None, scal, momentum,
                                       nesterov, weight_decay)
    return w, m if momentum else None


def _sgd_impl(w: torch.Tensor, g: torch.Tensor, m: Optional[torch.Tensor], scal: torch.Tensor,
              momentum: float, nesterov: bool, weight_decay: float) -> None:
    dev = w.device
    with torch.cuda.device(dev):
        rc = _library().sgd_epilogue(
            w.data_ptr(), DTYPES[w.dtype], g.data_ptr(), DTYPES[g.dtype],
            None if m is None else m.data_ptr(), w.numel(), scal.data_ptr(), momentum,
            int(nesterov), weight_decay, stream(dev))
    check_launch("sgd_epilogue", rc)
    launches["sgd_epilogue"] += 1


def _sgd_fake(w, g, m, scal, momentum, nesterov, weight_decay):
    return None


flat.kernel_op("sgd_epilogue", "(Tensor(a!) w, Tensor g, Tensor(b!)? m, Tensor scal, "
               "float momentum, bool nesterov, float weight_decay) -> ()", _sgd_impl, _sgd_fake)


def delta_amax(p: torch.Tensor, s: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """max |p - s + e| as a 0-dim fp32 device tensor: one partial per chunk,
    maxed here (NaN kept). p fp32 or bf16, s and e fp32."""
    if flat.takes_plain(p):
        return ref.delta_amax_flat_plain(p, s, e)
    dev = check_flat("delta_amax", {"p": p, "s": s, "e": e}, {"s": _F32, "e": _F32})
    if p.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=dev)
    return torch.ops.repro_torch.delta_amax(p, s, e)


def _amax_impl(p: torch.Tensor, s: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    dev = p.device
    partials = torch.empty(n_chunks(p.numel()), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _library().delta_amax(p.data_ptr(), DTYPES[p.dtype], s.data_ptr(), e.data_ptr(),
                                   p.numel(), partials.data_ptr(), stream(dev))
    check_launch("delta_amax", rc)
    launches["delta_amax"] += 1
    return torch.amax(partials)


def _amax_fake(p, s, e):
    return p.new_empty((), dtype=torch.float32)


flat.kernel_op("delta_amax", "(Tensor p, Tensor s, Tensor e) -> Tensor", _amax_impl, _amax_fake)


def delta_encode_i8(p: torch.Tensor, s: torch.Tensor, e: torch.Tensor, scale: float
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One int8 delta encode: returns (q, s, e) with q a new int8 buffer and
    the advanced shadow and residual written into s and e. `scale` is a host
    float, a power of two (`service.delta._pow2_scale`)."""
    if flat.takes_plain(p):
        return flat.delta_encode_i8_plain_(p, s, e, scale)
    dev = check_flat("delta_encode_i8", {"p": p, "s": s, "e": e}, {"s": _F32, "e": _F32})
    if p.numel() == 0:
        return torch.empty(p.shape, dtype=torch.int8, device=dev), s, e
    return torch.ops.repro_torch.delta_encode_i8(p, s, e, float(scale)), s, e


def _encode_impl(p: torch.Tensor, s: torch.Tensor, e: torch.Tensor, scale: float
                 ) -> torch.Tensor:
    dev = p.device
    q = torch.empty(p.shape, dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        rc = _library().delta_encode_i8(p.data_ptr(), DTYPES[p.dtype], s.data_ptr(),
                                        e.data_ptr(), q.data_ptr(), p.numel(), scale,
                                        stream(dev))
    check_launch("delta_encode_i8", rc)
    launches["delta_encode_i8"] += 1
    return q


def _encode_fake(p, s, e, scale):
    return torch.empty_like(p, dtype=torch.int8)


flat.kernel_op("delta_encode_i8", "(Tensor p, Tensor(a!) s, Tensor(b!) e, float scale) -> Tensor",
               _encode_impl, _encode_fake)
