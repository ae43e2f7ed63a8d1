"""The Mamba2 SSD scan: its Hopper kernels and their wrapper (counterpart of
`repro.kernels.mamba2_scan`).

The kernels (`csrc/mamba2_scan.cu`, CUDA C++ for sm_90a) replace the Pallas
TPU kernel `_ssd_kernel`; the source says what bounds them on the H100 and
how a chunk's products are spread over a CTA:

  mamba2_scan_fwd  y (B,S,H,P) in x's dtype and the final state (B,H,P,N) in
                   fp32, from an optional initial state, any S >= 1
  mamba2_scan_bwd  dx, db, dc (their inputs' dtypes), ddt, da, dd (summed
                   over B and S; da and dd over the heads' own b, db and dc
                   over the heads of a group), d init_state (fp32), from the
                   cotangents of y and of the final state: what `jax.grad`
                   of the oracle `ref.mamba2_chunked_jnp` gives (the TPU
                   kernel has none)

`mamba2_scan` takes x (B,S,H,P), dt (B,S,H) fp32, a and d (H,) fp32, b and c
(B,S,G,N) (x, b, c one dtype, fp32 or bf16), P and N up to `MAX_DIM`, G
dividing H. The kernels cut the sequence into chunks of their own length
(64); the chunk of the plain version (`chunk`, the model's `chunk_size`) does
not change the function. A tensor on the CPU goes to the plain version
(`ref.mamba2_chunked_plain`, differentiated by autograd); a CUDA tensor goes
through `Mamba2Scan`, a `torch.autograd.Function` whose forward and backward
launch the kernels, or raise. Both run chunk-parallel on the tensor cores:
each chunk's local state, the carries between chunks, then every chunk's
outputs from its entering state (`FWD_PHASES`); the backward adds the
cotangent's carry and the sums across CTAs (`BWD_PHASES`). The chunk states
live in fp32 scratch allocated per call (134 MB a buffer at zamba2's B 8 x
1024); the forward saves only its inputs. A forward of one chunk (S <= 64,
the decode step) is one kernel and allocates no scratch. The kernels are
built with nvcc at the first launch and bound through ctypes, so importing
this module needs neither nvcc nor a card. `launches[name]` counts each
forward and each backward once, however many CUDA kernels it takes. Each is
a `torch.library` custom op (`repro_torch::mamba2_scan_fwd` / `_bwd`): the
real implementation is the launch, the fake one gives the outputs' shapes
(the dry run, `utils.abstract`), and a flop formula counts M2_FWD_OPS /
M2_BWD_OPS a state element and step.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, flat, ref

SOURCE = build.CSRC / "mamba2_scan.cu"
MAX_DIM = 64
CHUNK = 64                      # the kernels' chunk length (`mamba2_chunk()` in the source)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"mamba2_scan_fwd": 0, "mamba2_scan_bwd": 0}    # since the last reset
_lib = None


def _library() -> ctypes.CDLL:
    """The built kernel library, with its C signatures declared (once)."""
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        dims = [ctypes.c_int] * 7                               # dtype, B, S, H, G, P, N
        lib.mamba2_fwd.argtypes = [ctypes.c_void_p] * 11 + dims + [ctypes.c_int, ctypes.c_void_p]
        lib.mamba2_bwd.argtypes = [ctypes.c_void_p] * 23 + dims + [ctypes.c_int, ctypes.c_void_p]
        lib.mamba2_fwd.restype = lib.mamba2_bwd.restype = lib.mamba2_chunk.restype = ctypes.c_int
        if lib.mamba2_chunk() != CHUNK:
            raise RuntimeError(f"mamba2 kernels chunk {lib.mamba2_chunk()} != {CHUNK}")
        _lib = lib
    return _lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           c: torch.Tensor, d: torch.Tensor, init_state: Optional[torch.Tensor]) -> None:
    named = {"x": x, "dt": dt, "a": a, "b": b, "c": c, "d": d}
    if init_state is not None:
        named["init_state"] = init_state
    if not all(flat.on_kernel_device(t) and t.device == x.device for t in named.values()):
        raise ValueError(f"mamba2 kernel needs every operand on one CUDA device; got "
                         f"{ {n: str(t.device) for n, t in named.items()} }")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"mamba2 kernel takes float32 or bfloat16 x/b/c of one dtype; got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    fp32 = {n: t for n, t in named.items() if n in ("dt", "a", "d", "init_state")}
    if any(t.dtype != torch.float32 for t in fp32.values()):
        raise TypeError(f"mamba2 kernel takes dt, a, d and init_state in float32; got "
                        f"{ {n: t.dtype for n, t in fp32.items()} }")
    if x.dim() != 4 or b.dim() != 4:
        raise ValueError(f"mamba2 expects x (B,S,H,P), b/c (B,S,G,N); got x {tuple(x.shape)}, "
                         f"b {tuple(b.shape)}")
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if (dt.shape != (bsz, s, h) or a.shape != (h,) or d.shape != (h,)
            or b.shape[:2] != (bsz, s) or c.shape != b.shape or min(bsz, s, h, p, g, n) < 1
            or h % g != 0):
        raise ValueError(f"incompatible shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}, "
                         f"d {tuple(d.shape)}")
    if init_state is not None and init_state.shape != (bsz, h, p, n):
        raise ValueError(f"init_state must be {(bsz, h, p, n)}, got {tuple(init_state.shape)}")
    if p > MAX_DIM or n > MAX_DIM:
        raise ValueError(f"mamba2 kernel takes P and N up to {MAX_DIM}, got {p} and {n}")
    if not all(t.is_contiguous() for t in named.values()):
        raise ValueError("mamba2 kernel needs contiguous operands")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


FWD_PHASES = {"chunk": 1, "carry": 2, "out": 4}                 # the C entry's `phases` bits
FWD_ALL = sum(FWD_PHASES.values())


def fwd_buffers(x: torch.Tensor, b: torch.Tensor) -> dict:
    """The forward's outputs (y, state) and, with more than one chunk, its
    scratch (hbuf: the chunks' states, etot: exp(total) a chunk)."""
    bsz, s, h, p = x.shape
    n = b.shape[3]
    nc = -(-s // CHUNK)
    f32 = dict(dtype=torch.float32, device=x.device)
    bufs = dict(y=torch.empty_like(x), state=torch.empty((bsz, h, p, n), **f32), hbuf=None,
                etot=None)
    if nc > 1:
        bufs.update(hbuf=torch.empty((bsz, h, nc, p, n), **f32),
                    etot=torch.empty((bsz, h, nc), **f32))
    return bufs


def run_fwd(x, dt, a, b, c, d, init_state, bufs: dict, phases: int = FWD_ALL) -> None:
    """Launch the forward's `phases` (FWD_PHASES bits; with one chunk "out"
    is the whole forward) on checked inputs into `bufs` (fwd_buffers);
    counts nothing."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    with torch.cuda.device(x.device):
        rc = _library().mamba2_fwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            d.data_ptr(), _ptr(init_state), bufs["y"].data_ptr(), bufs["state"].data_ptr(),
            _ptr(bufs["hbuf"]), _ptr(bufs["etot"]), _DTYPES[x.dtype], bsz, s, h, g, p, n,
            phases, _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"mamba2_scan_fwd kernel launch failed: CUDA error {rc}")


def _fwd_impl(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor, d: torch.Tensor, init_state: Optional[torch.Tensor]
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One forward (its kernels' phases) on checked inputs: (y, final
    state); the op's CUDA kernel (the fake below gives the outputs' shapes;
    the scratch is this body's own)."""
    bufs = fwd_buffers(x, b)
    run_fwd(x, dt, a, b, c, d, init_state, bufs)
    launches["mamba2_scan_fwd"] += 1
    return bufs["y"], bufs["state"]


def _fwd_fake(x, dt, a, b, c, d, init_state):
    bsz, s, h, p = x.shape
    return torch.empty_like(x), x.new_empty((bsz, h, p, b.shape[3]), dtype=torch.float32)


_ARGS = "Tensor x, Tensor dt, Tensor a, Tensor b, Tensor c, Tensor d, Tensor? init_state"
flat.kernel_op("mamba2_scan_fwd", f"({_ARGS}) -> (Tensor, Tensor)", _fwd_impl, _fwd_fake)


def _launch_fwd(x, dt, a, b, c, d, init_state) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward (its op) on checked inputs: (y, final state)."""
    return torch.ops.repro_torch.mamba2_scan_fwd(x, dt, a, b, c, d, init_state)


BWD_PHASES = {"chunk": 1, "carry": 2, "grad": 4, "reduce": 8}   # the C entry's `phases` bits
BWD_ALL = sum(BWD_PHASES.values())


def bwd_buffers(x: torch.Tensor, b: torch.Tensor) -> dict:
    """The backward's outputs and scratch for inputs shaped as x and b."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = -(-s // CHUNK)
    f32 = dict(dtype=torch.float32, device=x.device)
    return dict(
        dx=torch.empty_like(x), ddt=torch.empty((bsz, s, h), **f32),
        db=torch.empty_like(b), dc=torch.empty_like(b),
        da=torch.empty((h,), **f32), dd=torch.empty((h,), **f32),
        ds0=torch.empty((bsz, h, p, n), **f32),
        hbuf=torch.empty((bsz, h, nc, p, n), **f32), gbuf=torch.empty((bsz, h, nc, p, n), **f32),
        etot=torch.empty((bsz, h, nc), **f32), db_part=torch.empty((bsz, s, h, n), **f32),
        dc_part=torch.empty((bsz, s, h, n), **f32), da_part=torch.empty((bsz, h, nc), **f32),
        dd_part=torch.empty((bsz, h, nc), **f32))


def run_bwd(x, dt, a, b, c, d, init_state, dy, d_state, bufs: dict,
            phases: int = BWD_ALL) -> None:
    """Launch the backward's `phases` (BWD_PHASES bits) on checked inputs into
    `bufs` (bwd_buffers); counts nothing."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    dev = x.device
    out = [bufs[k].data_ptr() for k in ("dx", "ddt", "db", "dc", "da", "dd", "ds0", "hbuf",
                                        "gbuf", "etot", "db_part", "dc_part", "da_part",
                                        "dd_part")]
    with torch.cuda.device(dev):
        rc = _library().mamba2_bwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            d.data_ptr(), _ptr(init_state), _ptr(dy), _ptr(d_state), *out, _DTYPES[x.dtype],
            bsz, s, h, g, p, n, phases, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"mamba2_scan_bwd kernel launch failed: CUDA error {rc}")


def _bwd_impl(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor, d: torch.Tensor, init_state: Optional[torch.Tensor],
              dy: Optional[torch.Tensor], d_state: Optional[torch.Tensor]
              ) -> tuple[torch.Tensor, ...]:
    """One backward (its kernels' four phases) on checked inputs; dy /
    d_state may be None (zero). Returns (dx, ddt, da, db, dc, dd,
    d_init_state); the op's CUDA kernel, as the forward's."""
    bufs = bwd_buffers(x, b)
    run_bwd(x, dt, a, b, c, d, init_state, dy, d_state, bufs)
    launches["mamba2_scan_bwd"] += 1
    return tuple(bufs[k] for k in ("dx", "ddt", "da", "db", "dc", "dd", "ds0"))


def _bwd_fake(x, dt, a, b, c, d, init_state, dy, d_state):
    bsz, s, h, p = x.shape
    f32 = dict(dtype=torch.float32)
    return (torch.empty_like(x), dt.new_empty((bsz, s, h), **f32), a.new_empty((h,), **f32),
            torch.empty_like(b), torch.empty_like(c), d.new_empty((h,), **f32),
            x.new_empty((bsz, h, p, b.shape[3]), **f32))


flat.kernel_op("mamba2_scan_bwd", f"({_ARGS}, Tensor? dy, Tensor? d_state) -> "
               "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)", _bwd_impl, _bwd_fake)


def _launch_bwd(x, dt, a, b, c, d, init_state, dy, d_state) -> tuple[torch.Tensor, ...]:
    """The backward (its op) on checked inputs: (dx, ddt, da, db, dc, dd,
    d_init_state)."""
    return tuple(torch.ops.repro_torch.mamba2_scan_bwd(x, dt, a, b, c, d, init_state, dy,
                                                        d_state))


# fp32 ops per state element and step that the function needs: the least
# over its forms, which is the recurrence's (a chunked form adds its (T, T)
# products, more of them the longer its chunk, so its count would describe a
# kernel, not the function). Forward (5): the decay multiply, the xd B^T
# multiply-add and the y = h C multiply-add. Backward (14), with h rebuilt
# from the initial state: the rebuild (3), the dh carry (3: the dy C^T
# multiply-add and the decay), dxd = dh B, dB = dh^T xd, dC = h^T dy and dla
# = sum(dh h) (2 each).
M2_FWD_OPS, M2_BWD_OPS = 5, 14


def scan_flops(x_shape, b_shape, backward: bool) -> int:
    """fp32 operations the SSD scan needs on x (B,S,H,P), b (B,S,G,N):
    M2_FWD_OPS or M2_BWD_OPS a state element and step."""
    bsz, s, h, p = x_shape
    return (M2_BWD_OPS if backward else M2_FWD_OPS) * bsz * s * h * p * b_shape[3]


@register_flop_formula(torch.ops.repro_torch.mamba2_scan_fwd)
def _fwd_flops(x_shape, dt_shape, a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return scan_flops(x_shape, b_shape, backward=False)


@register_flop_formula(torch.ops.repro_torch.mamba2_scan_bwd)
def _bwd_flops(x_shape, dt_shape, a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return scan_flops(x_shape, b_shape, backward=True)


class Mamba2Scan(torch.autograd.Function):
    """Forward: the forward's kernels. Backward: the backward's kernels, from
    the saved inputs (the backward rebuilds the chunks' states it needs)."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, d, init_state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, b, c, d, init_state)
        return _launch_fwd(x, dt, a, b, c, d, init_state)

    @staticmethod
    def backward(ctx, dy, d_state):
        x, dt, a, b, c, d, init_state = ctx.saved_tensors
        dy = None if dy is None else dy.contiguous()
        d_state = None if d_state is None else d_state.contiguous()
        *grads, ds0 = _launch_bwd(x, dt, a, b, c, d, init_state, dy, d_state)
        return (*grads, None if init_state is None else ds0)


def mamba2_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, d: torch.Tensor, init_state: Optional[torch.Tensor] = None,
                chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD mixing; returns (y (B,S,H,P) in x's dtype, final state
    (B,H,P,N) fp32). `chunk` is the plain version's (CPU tensors)."""
    if flat.takes_plain(x):
        return ref.mamba2_chunked_plain(x, dt, a, b, c, d, chunk=chunk, init_state=init_state)
    _check(x, dt, a, b, c, d, init_state)
    return Mamba2Scan.apply(x, dt, a, b, c, d, init_state)
