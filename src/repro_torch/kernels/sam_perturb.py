"""The SAM perturbation's flat-bucket kernels and their wrappers
(counterpart of `repro.kernels.sam_perturb`).

The kernels (`csrc/sam_perturb.cu`, CUDA C++ for sm_90a) replace the Pallas
TPU kernels of the reference module:

  sq_norm      sum of g^2 in fp32: one fp32 partial per
               `sq_norm_tile()`-element tile, summed here with `torch.sum`
               (the reference sums its per-chunk partials with `jnp.sum`)
  sam_perturb  w + rho * g / (sqrt(n) + 1e-12), the scale computed by the
               kernel itself from rho (a host number or a device scalar) and
               the device squared norm, in the reference's order; w's dtype
               out, into `out` when given (which may be w)

The port's SAM perturbation runs the two (`core.perturb.perturb` when it is
not handed a norm); AsyncSAM carries its norm and perturbs through
`fused_axpy`.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
raises. `launches[name]` counts each kernel's launches. Each launch is a
`torch.library` custom op (`repro_torch::<name>`) whose fake implementation
gives its output's shape (the dry run, `utils.abstract`); these bandwidth
kernels register no flop formula.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, flat, ref
from repro_torch.kernels.flat import DTYPES, check_flat, check_launch, stream

SOURCE = build.CSRC / "sam_perturb.cu"

launches = {"sq_norm": 0, "sam_perturb": 0}    # since the last reset
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        lib.sq_norm.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                                ctypes.c_void_p, ctypes.c_void_p]
        lib.sam_perturb.argtypes = [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_void_p]
        for fn in (lib.sq_norm, lib.sq_norm_tile, lib.sam_perturb):
            fn.restype = ctypes.c_int
        lib.tile = lib.sq_norm_tile()
        _lib = lib
    return _lib


def sq_norm(g: torch.Tensor) -> torch.Tensor:
    """Sum of squares of a flat vector, fp32 (a 0-dim tensor)."""
    if flat.takes_plain(g):
        return ref.sq_norm_plain(g)
    dev = check_flat("sq_norm", {"g": g})
    if g.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=dev)
    return torch.ops.repro_torch.sq_norm(g)


def _sq_norm_impl(g: torch.Tensor) -> torch.Tensor:
    """The launch on a checked, non-empty g and the sum of its partials: the
    op's CUDA kernel (the fake gives the 0-dim fp32 result)."""
    dev, lib = g.device, _library()
    partials = torch.empty(-(-g.numel() // lib.tile), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sq_norm(g.data_ptr(), DTYPES[g.dtype], g.numel(), partials.data_ptr(),
                         stream(dev))
    check_launch("sq_norm", rc)
    launches["sq_norm"] += 1
    return torch.sum(partials)


def _sq_norm_fake(g):
    return g.new_empty((), dtype=torch.float32)


flat.kernel_op("sq_norm", "(Tensor g) -> Tensor", _sq_norm_impl, _sq_norm_fake)


def sq_norm_tile() -> int:
    """Elements a tile of the sq_norm kernel's sweep."""
    return _library().tile


def sam_perturb(w: torch.Tensor, g: torch.Tensor, rho, sq_norm, *,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """w + rho * g / (sqrt(sq_norm) + 1e-12) over flat vectors, w's dtype, into
    `out` when given. rho and sq_norm may be device scalars."""
    if flat.takes_plain(w):
        return flat.sam_perturb_plain(w, g, rho, sq_norm, out)
    if out is None:
        out = torch.empty_like(w)
    dev = check_flat("sam_perturb", {"w": w, "g": g, "out": out}, {"out": (w.dtype,)})
    if w.numel() == 0:
        return out
    # rho / (sqrt(sq_norm) + 1e-12) is the kernel's: a device rho is read
    # there, a host one passed by value
    sq = torch.as_tensor(sq_norm).to(dev, torch.float32)
    rho_dev = rho.to(dev, torch.float32) if isinstance(rho, torch.Tensor) else None
    torch.ops.repro_torch.sam_perturb(float(rho) if rho_dev is None else 0.0, rho_dev, sq,
                                      w, g, out)
    return out


def _sam_perturb_impl(rho: float, rho_dev: Optional[torch.Tensor], sq: torch.Tensor,
                      w: torch.Tensor, g: torch.Tensor, out: torch.Tensor) -> None:
    """The launch on checked, non-empty operands, into `out` (which may be
    w): the op's CUDA kernel."""
    dev = w.device
    with torch.cuda.device(dev):
        rc = _library().sam_perturb(rho, None if rho_dev is None else rho_dev.data_ptr(),
                                    sq.data_ptr(), w.data_ptr(), DTYPES[w.dtype], g.data_ptr(),
                                    DTYPES[g.dtype], out.data_ptr(), w.numel(), stream(dev))
    check_launch("sam_perturb", rc)
    launches["sam_perturb"] += 1


def _sam_perturb_fake(rho, rho_dev, sq, w, g, out):
    return None


flat.kernel_op("sam_perturb", "(float rho, Tensor? rho_dev, Tensor sq, Tensor w, Tensor g, "
               "Tensor(a!) out) -> ()", _sam_perturb_impl, _sam_perturb_fake)
