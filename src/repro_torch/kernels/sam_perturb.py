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
raises. `launches[name]` counts each kernel's launches.
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
    if g.device.type == "cpu":
        return ref.sq_norm_plain(g)
    dev = check_flat("sq_norm", {"g": g})
    if g.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=dev)
    lib = _library()
    partials = torch.empty(-(-g.numel() // lib.tile), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sq_norm(g.data_ptr(), DTYPES[g.dtype], g.numel(), partials.data_ptr(),
                         stream(dev))
    check_launch("sq_norm", rc)
    launches["sq_norm"] += 1
    return torch.sum(partials)


def sq_norm_tile() -> int:
    """Elements a tile of the sq_norm kernel's sweep."""
    return _library().tile


def sam_perturb(w: torch.Tensor, g: torch.Tensor, rho, sq_norm, *,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """w + rho * g / (sqrt(sq_norm) + 1e-12) over flat vectors, w's dtype, into
    `out` when given. rho and sq_norm may be device scalars."""
    if w.device.type == "cpu":
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
    with torch.cuda.device(dev):
        rc = _library().sam_perturb(float(rho) if rho_dev is None else 0.0,
                                    None if rho_dev is None else rho_dev.data_ptr(),
                                    sq.data_ptr(), w.data_ptr(), DTYPES[w.dtype], g.data_ptr(),
                                    DTYPES[g.dtype], out.data_ptr(), w.numel(), stream(dev))
    check_launch("sam_perturb", rc)
    launches["sam_perturb"] += 1
    return out
