"""Sum of squares of a flat bucket: the Hopper kernel and its wrapper
(counterpart of the `sq_norm` half of `repro.kernels.sam_perturb`).

The kernel (`csrc/sam_perturb.cu`, CUDA C++ for sm_90a) replaces the Pallas
TPU kernel `_sq_norm_kernel`: one fp32 partial per `flat.CHUNK`-element chunk,
summed here with `torch.sum`, as the reference wrapper sums its partials with
`jnp.sum`. The reference's `sam_perturb` kernel is not on the training path
(AsyncSAM perturbs through `fused_axpy`) and is not ported yet.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
raises. `launches` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flat import DTYPES, check_flat, check_launch, n_chunks, stream

SOURCE = build.CSRC / "sam_perturb.cu"

launches = 0          # kernel launches since the last reset (plain int)
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        lib.sq_norm.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                                ctypes.c_void_p, ctypes.c_void_p]
        lib.sq_norm.restype = ctypes.c_int
        _lib = lib
    return _lib


def sq_norm(g: torch.Tensor) -> torch.Tensor:
    """Sum of squares of a flat vector, fp32 (partial per chunk, summed here)."""
    global launches
    if g.device.type == "cpu":
        return ref.sq_norm_plain(g)
    dev = check_flat("sq_norm", {"g": g})
    if g.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=dev)
    partials = torch.empty(n_chunks(g.numel()), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _library().sq_norm(g.data_ptr(), DTYPES[g.dtype], g.numel(),
                                partials.data_ptr(), stream(dev))
    check_launch("sq_norm", rc)
    launches += 1
    return torch.sum(partials)
