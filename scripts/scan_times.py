#!/usr/bin/env python3
"""Device times of the scan kernels and sq_norm at the models' shapes.

    python3 scripts/scan_times.py TAG [--sq-layouts]

Times (CUDA events, `chip_smoke.time_ms`) the Mamba2 SSD forward at
zamba2-1.2b's descent, ascent and decode shapes (8 and 2 x 1024, and 8 x 1
from a state; 64 heads, P = N = 64, bf16), with its phases alone where the
wrapper has them (`mamba2_scan.FWD_PHASES`); the wkv forward at rwkv6-7b's
shape (8 x 1024, 64 heads of 64, bf16) and its decode step (8 x 1 from a
state); the wkv backward at rwkv6-7b's shape, a decode step and K = V = 16
in fp32; and sq_norm beside `torch.linalg.vector_norm(x) ** 2` at olmo-1b's
fp32 bucket (1,176,764,416 elements). It imports the checkout it is run
from (its `src` and its `chip_smoke.py`), so two trees compare in one call
on one card: unpack the other tree with `git archive` into a directory
`.gitignore` lists, and run this script from each root in turns (parent,
change, change, parent). Prints TAG and one JSON object of milliseconds.

--sq-layouts also times sq_norm's two layouts of its sweep, built from the
tree's `csrc/sam_perturb.cu` with the launch's grid rewritten (into
`build/sq_layouts/`): one 4,096-element tile a CTA (the kernel as it is)
and a fixed grid of 528, 1,056 or 2,112 CTAs that take the tiles in turn;
each sweep alone and with `torch.sum` of its partials. Needs one NVIDIA GPU
and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import sys

ROOT = pathlib.Path.cwd()
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

M2_SHAPES = {"m2 B8": ((8, 1024, 64, 64, 64, 1), False), "m2 B2": ((2, 1024, 64, 64, 64, 1), False),
             "m2 decode": ((8, 1, 64, 64, 64, 1), True)}
WKV_FWD_SHAPES = {"wkv fwd": ((8, 1024, 64, 64, 64), "bfloat16", False),
                  "wkv fwd decode": ((8, 1, 64, 64, 64), "bfloat16", True)}
WKV_SHAPES = {"wkv bwd": ((8, 1024, 64, 64, 64), "bfloat16", False),
              "wkv bwd decode": ((8, 1, 64, 64, 64), "bfloat16", True),
              "wkv bwd K16 fp32": ((8, 1024, 4, 16, 16), "float32", True)}
SQ_NORM_N = 1_176_764_416             # olmo-1b's fp32 parameter bucket
SQ_LAUNCH = "sq_norm_kernel<T><<<n_red_tiles(n), THREADS, 0, s>>>("
SQ_GRIDS = {"a tile a CTA": None, "grid 528": 528, "grid 1056": 1056, "grid 2112": 2112}


def sq_layouts(x) -> dict:
    """sq_norm's layouts (ms): each sweep alone, and with `torch.sum` of its
    partials (the wrapper's whole call); its error against the plain sum."""
    import torch

    import chip_smoke as c
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import sam_perturb as sp
    base = sp.SOURCE.read_text()
    if base.count(SQ_LAUNCH) != 1:
        raise RuntimeError(f"{sp.SOURCE}: the sweep's launch not found once: {SQ_LAUNCH!r}")
    out_dir = ROOT / "build" / "sq_layouts"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in sp.SOURCE.parent.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())
    paths = {}
    for name, ctas in SQ_GRIDS.items():
        grid = SQ_LAUNCH if ctas is None else SQ_LAUNCH.replace(
            "n_red_tiles(n)", f"(n_red_tiles(n) < {ctas}u ? n_red_tiles(n) : {ctas}u)")
        paths[name] = out_dir / f"sq_{ctas or 'tiles'}.cu"
        paths[name].write_text(base.replace(SQ_LAUNCH, grid))
    libs = build.build(list(paths.values()))
    n = x.numel()
    tiles = -(-n // sp.sq_norm_tile())
    want = float(ref.sq_norm_plain(x))
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(libs[path]))
        lib.sq_norm.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                                ctypes.c_void_p, ctypes.c_void_p]
        partials = torch.empty(min(SQ_GRIDS[name] or tiles, tiles), device="cuda")

        def sweep() -> None:
            rc = lib.sq_norm(x.data_ptr(), 0, n, partials.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"sq_norm {name}: launch failed, CUDA error {rc}")

        def whole() -> torch.Tensor:
            sweep()
            return torch.sum(partials)

        res[f"{name} sweep"] = c.time_ms(sweep)
        res[f"{name} whole"] = c.time_ms(whole)
        res[f"{name} rel err"] = abs(float(whole()) - want) / want
    return res


def main() -> int:
    import torch

    import chip_smoke as c
    from repro_torch.kernels import build
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import rwkv6_scan as r6
    from repro_torch.kernels import sam_perturb as sp

    if not torch.cuda.is_available():
        raise SystemExit("scan_times: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build([m2.SOURCE, r6.SOURCE, sp.SOURCE])
    out = {}
    for name, (shape, init) in M2_SHAPES.items():
        x, dt, a, b, cc, d, s0 = c.m2_inputs(shape, "bfloat16", init, False)
        out[name] = c.time_ms(lambda: m2.mamba2_scan(x, dt, a, b, cc, d, s0))
        if hasattr(m2, "run_fwd"):
            bufs = m2.fwd_buffers(x, b)
            m2.run_fwd(x, dt, a, b, cc, d, s0, bufs)
            out[name + " phases"] = {
                k: c.time_ms(lambda bit=bit: m2.run_fwd(x, dt, a, b, cc, d, s0, bufs, bit))
                for k, bit in m2.FWD_PHASES.items()}
    for name, (shape, dtype, init) in WKV_FWD_SHAPES.items():
        r, k, v, w, u, s0 = c.wkv_inputs(shape, dtype, init)
        out[name] = c.time_ms(lambda: r6.rwkv6_scan(r, k, v, w, u, s0))
    for name, (shape, dtype, init) in WKV_SHAPES.items():
        r, k, v, w, u, s0 = c.wkv_inputs(shape, dtype, init)
        g = torch.Generator(device="cuda").manual_seed(4)
        dy = torch.randn(r.shape[:3] + (shape[4],), generator=g, device="cuda").to(r.dtype)
        ds = torch.randn((shape[0], shape[2], shape[3], shape[4]), generator=g, device="cuda")
        out[name] = c.time_ms(lambda: r6._launch_bwd(r, k, v, w, u, s0, dy, ds))
    del r, k, v, w, u, s0, dy, ds
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.empty(SQ_NORM_N, device="cuda").normal_(0.0, 1e-3, generator=g)
    out["sq_norm"] = c.time_ms(lambda: sp.sq_norm(x))
    out["vector_norm_sq"] = c.time_ms(lambda: torch.linalg.vector_norm(x) ** 2)
    if "--sq-layouts" in sys.argv[2:]:
        out["sq_norm layouts"] = sq_layouts(x)
    print(sys.argv[1] if len(sys.argv) > 1 else "tree", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
