#!/usr/bin/env python3
"""Where the wkv forward spends its time, on the card.

    python3 scripts/wkv_fwd_ablation.py

Builds variants of `src/repro_torch/csrc/rwkv6_scan.cu` that each take one
part out or change one thing (the source is rewritten at fixed anchors into
`build/wkv_fwd_ablation/`; a missing anchor fails the run) and times the
forward (CUDA events) at rwkv6-7b's scan shape (8 x 1024, 64 heads of 64,
bf16) and its decode step (8 x 1 from a state):

  full          the kernel as it is
  rows_in_regs  every step reads step 0's rows (r, k, exp(w), r u k): the
                row loads are hoisted out of the serial loop into registers
  no_group_sum  y's partials not summed over the row groups (each thread's
                own partial written)
  no_prefetch   the chunk copied just before it is staged, not during the
                previous chunk's serial loop
  scalar_copy   the chunk copied element by element (the path for K or V
                not a multiple of 16 bytes), not by 16-byte cp.async
  half_warps    8 columns a thread: 2 warps a (b, h) in place of 4
  no_unroll     the serial loop not unrolled

A variant's output is not a result (it skips work); only its time is read.
Prints the card (nvidia-smi), one JSON line per variant with its registers
and spills (ptxas), and the opcode counts of the full kernel's machine code
(cuobjdump -sass). Needs one NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SHAPES = {"model": ((8, 1024, 64, 64, 64), False), "decode": ((8, 1, 64, 64, 64), True)}
PREFETCH = ("    if (t0 + FTC < S) copy(t0 + FTC);              "
            "// lands during this chunk's serial loop\n")
WAIT = "    cp_async_wait_all();\n"
UNROLL = "#pragma unroll 2\n    for (int step = 0; step < tc; ++step) {"
VARIANTS = {
    "full": [],
    "rows_in_regs": [("srow[step * NP + rg + 9 * m]", "srow[rg + 9 * m]")],
    "no_group_sum": [("const float yt = group_sum<C>(yp, lane);", "const float yt = yp[0];")],
    "no_prefetch": [(PREFETCH, ""), (WAIT, "    if (t0 > 0) copy(t0);\n" + WAIT)],
    "scalar_copy": [("const bool vec_in = K", "const bool vec_in = false && K")],
    "half_warps": [("constexpr int FWD_C = 4;", "constexpr int FWD_C = 8;")],
    "no_unroll": [(UNROLL, UNROLL.split("\n", 1)[1])],
}


def variant_sources() -> dict[str, pathlib.Path]:
    from repro_torch.kernels import rwkv6_scan as r6
    base = r6.SOURCE.read_text()
    out_dir = ROOT / "build" / "wkv_fwd_ablation"
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
    """Registers and spills of the bf16 N = 64 forward kernel on the 16-byte
    copy path (the model's), from ptxas."""
    lines = lib.with_name(lib.name + ".log").read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "wkv_fwd_kernelILi64E13__nv_bfloat16Lb1E" in line:
            return " ".join(part.strip() for part in lines[i + 1:i + 4])
    return "not found"


def sass_histogram(lib: pathlib.Path) -> dict:
    """Opcode counts of the bf16 N = 64 forward kernel's machine code on the
    16-byte copy path (cuobjdump -sass), most frequent first."""
    import collections
    import re
    import shutil
    import subprocess
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, inside = collections.Counter(), False
    for line in text.splitlines():
        if "Function :" in line:
            inside = "wkv_fwd_kernelILi64E13__nv_bfloat16Lb1E" in line
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m:
                counts[m.group(1)] += 1
    return dict(counts.most_common())


def main() -> int:
    import torch

    import chip_smoke
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("wkv_fwd_ablation: needs an NVIDIA GPU")
    print(chip_smoke.nvidia_smi(), flush=True)
    paths = variant_sources()
    libs = build.build(list(paths.values()))
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    for shape_name, (shape, init) in SHAPES.items():
        b, s, h, dk, dv = shape
        r, k, v, w, u, s0 = chip_smoke.wkv_inputs(shape, "bfloat16", init)
        y = torch.empty((b, s, h, dv), dtype=r.dtype, device="cuda")
        state = torch.empty((b, h, dk, dv), device="cuda")
        ptrs = [t.data_ptr() for t in (r, k, v, w, u)]
        ptrs += [None if s0 is None else s0.data_ptr(), y.data_ptr(), state.data_ptr()]
        calls[shape_name] = (ptrs, shape, (r, k, v, w, u, s0, y, state))
    for name, path in paths.items():
        lib = ctypes.CDLL(str(libs[path]))
        lib.rwkv6_fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        row = dict(variant=name)
        for shape_name, (ptrs, (b, s, h, dk, dv), _) in calls.items():
            def call() -> None:
                rc = lib.rwkv6_fwd(*ptrs, 1, b, s, h, dk, dv, stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: launch failed, CUDA error {rc}")

            row[f"{shape_name} ms"] = chip_smoke.time_ms(call)
        row["ptxas"] = ptxas_line(libs[path])
        print(json.dumps(row), flush=True)
    print("sass full " + json.dumps(sass_histogram(libs[paths["full"]])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
