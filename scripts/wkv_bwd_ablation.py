#!/usr/bin/env python3
"""Where the wkv backward spends its time, on the card.

    python3 scripts/wkv_bwd_ablation.py

Builds variants of `src/repro_torch/csrc/rwkv6_scan.cu` that each take one
part out or change one thing (the source is rewritten at fixed anchors into
`build/wkv_bwd_ablation/`; a missing anchor fails the run) and times the
backward (CUDA events) at rwkv6-7b's scan shape (8 x 1024, 64 heads of 64,
bf16):

  full          the kernel as it is
  no_pass1      pass 1 (S rebuilt, p = S dy) skipped: pass 2 alone
  no_colsum     dv's column sums over a warp's rows not exchanged (each
                thread's own 4 products stored in their place)
  no_dv         the block's dv not summed across warps nor stored
  no_rows       the block's staged row outputs (dr, dk, dw) not stored
  no_unroll     the serial loops not unrolled
  one_cta       launch bounds of one CTA an SM (no register cap, no spills)

A variant's output is not a result (it skips work); only its time is read.
Prints the card (nvidia-smi), each variant's registers and spills (ptxas),
and one JSON line per variant. Needs one NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SHAPE = (8, 1024, 64, 64, 64)
PASS1 = ("  for (int t0 = 0; t0 < S; t0 += TC) {\n    const int tc = min(TC, S - t0);\n"
         "    __syncthreads();                               // the last chunk's readers are done\n"
         "    if (t0 > 0) flush_rows")
UNROLL1 = "#pragma unroll 2\n    for (int t = 0; t < tc; ++t) {"
UNROLL2 = "#pragma unroll 2\n      for (int t = t1 - 1; t >= ts; --t) {"
ROWS = ("      flush_rows(rows, dr, t0 + ts, t1 - ts);\n"
        "      flush_rows(rows + SB * N, dk, t0 + ts, t1 - ts);\n"
        "      flush_rows(rows + 2 * SB * N, dw, t0 + ts, t1 - ts);\n")
VARIANTS = {
    "full": [],
    "no_pass1": [(PASS1, PASS1.replace("t0 < S;", "t0 < 0;"))],
    "no_colsum": [("        const float4 cs = column_sums<CW>(pr);",
                   "        const float4 cs = make_float4(pr[0], pr[1], pr[2], pr[3]);")],
    "no_dv": [("      for (int idx = threadIdx.x; idx < (t1 - ts) * N; idx += NTH) {",
               "      for (int idx = threadIdx.x; idx < 0; idx += NTH) {")],
    "no_rows": [(ROWS, "")],
    "no_unroll": [(UNROLL1, UNROLL1.split("\n", 1)[1]), (UNROLL2, UNROLL2.split("\n", 1)[1])],
    "one_cta": [("__launch_bounds__(4 * N, 128 / N)", "__launch_bounds__(4 * N, 1)")],
}


def variant_sources() -> dict[str, pathlib.Path]:
    from repro_torch.kernels import rwkv6_scan as r6
    base = r6.SOURCE.read_text()
    out_dir = ROOT / "build" / "wkv_bwd_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, edits in VARIANTS.items():
        src = base
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: anchor not found once in {r6.SOURCE}: {old!r}")
            src = src.replace(old, new)
        paths[name] = out_dir / f"wkv_{name}.cu"
        paths[name].write_text(src)
    return paths


def ptxas_line(lib: pathlib.Path) -> str:
    """Registers and spills of the bf16 N = 64 backward kernel, from ptxas."""
    lines = lib.with_name(lib.name + ".log").read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "wkv_bwd_kernelILi64E13__nv_bfloat16" in line:
            return " ".join(part.strip() for part in lines[i + 2:i + 4])
    return "not found"


def main() -> int:
    import torch

    import chip_smoke
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("wkv_bwd_ablation: needs an NVIDIA GPU")
    print(chip_smoke.nvidia_smi(), flush=True)
    paths = variant_sources()
    libs = build.build(list(paths.values()))
    b, s, h, dk, dv = SHAPE
    r, k, v, w, u, s0 = chip_smoke.wkv_inputs(SHAPE, "bfloat16", False)
    gen = torch.Generator(device="cuda").manual_seed(4)
    dy = torch.randn((b, s, h, dv), generator=gen, device="cuda").to(r.dtype)
    ds = torch.randn((b, h, dk, dv), generator=gen, device="cuda")
    outs = [torch.empty_like(t) for t in (r, k, v, w)]
    du_part = torch.empty((b, h, dk), device="cuda")
    du = torch.empty((h, dk), device="cuda")
    ds0 = torch.empty_like(ds)
    ptrs = [t.data_ptr() for t in (r, k, v, w, u)] + [None, dy.data_ptr(), ds.data_ptr()]
    ptrs += [t.data_ptr() for t in (*outs, du_part, du, ds0)]
    stream = torch.cuda.current_stream().cuda_stream
    for name, path in paths.items():
        lib = ctypes.CDLL(str(libs[path]))
        lib.rwkv6_bwd.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

        def call() -> None:
            rc = lib.rwkv6_bwd(*ptrs, 1, b, s, h, dk, dv, stream)
            if rc != 0:
                raise RuntimeError(f"{name}: launch failed, CUDA error {rc}")

        row = dict(variant=name, ms=chip_smoke.time_ms(call), ptxas=ptxas_line(libs[path]))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
