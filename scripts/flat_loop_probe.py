#!/usr/bin/env python3
"""Why a flat-bucket elementwise kernel runs behind `torch.add`, on the card.

    python3 scripts/flat_loop_probe.py

Times out = w + scale g over olmo-1b's fp32 bucket (1,176,764,416 elements)
as four loops of `scripts/flat_loop_probe.cu` (the flat kernels' chunk loop
with w loaded first, as sam_perturb ran it before it swept; the same loop
with g loaded first, fused_axpy's order; the chunk loop with a batch's loads
before its stores; the sweep of flat_buffer.cuh), beside the shipped
`sam_perturb` and `fused_axpy` wrappers and `torch.add` (the loops read a
scale computed once on the device), in turns: forward, backward, forward,
backward. Every loop is held to the plain version bit for bit.
Prints the card (nvidia-smi), one JSON line per candidate with its four
times, and the order of the global loads and stores in the two chunk loops'
machine code (cuobjdump). Needs one NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
SOURCE = ROOT / "scripts" / "flat_loop_probe.cu"
LOOPS = {"chunk, w loaded first": 0, "chunk, g loaded first": 1,
         "chunk, loads before stores": 2, "sweep": 3}
RHO = 0.05


def memory_order(library: pathlib.Path, kernel: str) -> list[str]:
    """The global loads and stores of `kernel`'s machine code, in order."""
    from repro_torch.kernels import build
    cuobjdump = pathlib.Path(build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    body = sass[sass.index(kernel):]
    body = body[:body.find("Function :", 10)] if "Function :" in body[10:] else body
    return [re.sub(r"\s+", " ", m.group(1)) for m in
            re.finditer(r"\*/\s*((?:LDG|STG)[^;]*);", body)]


def main() -> int:
    import torch

    import chip_smoke
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import sam_perturb as sp

    if not torch.cuda.is_available():
        raise SystemExit("flat_loop_probe: needs an NVIDIA GPU")
    print(chip_smoke.nvidia_smi(), flush=True)
    library = build.build([SOURCE, sp.SOURCE, fu.SOURCE])[SOURCE]
    lib = ctypes.CDLL(str(library))
    lib.flat_loop.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int64,
                                                                      ctypes.c_void_p]
    n = chip_smoke.OLMO_1B_BUCKET
    gen = torch.Generator(device="cuda").manual_seed(1)
    g = torch.empty(n, device="cuda").normal_(0.0, 1e-3, generator=gen)
    w = torch.empty(n, device="cuda").normal_(0.0, 2e-2, generator=gen)
    sq = ref.sq_norm_plain(g)
    scale = ref.sam_perturb_scale(RHO, sq, g.device)
    out = torch.empty_like(w)
    stream = torch.cuda.current_stream().cuda_stream

    def loop(variant: int):
        def run():
            rc = lib.flat_loop(variant, scale.data_ptr(), w.data_ptr(), g.data_ptr(),
                               out.data_ptr(), n, stream)
            if rc != 0:
                raise RuntimeError(f"flat_loop {variant}: CUDA error {rc}")
        return run

    candidates = {name: loop(v) for name, v in LOOPS.items()}
    candidates["sam_perturb (wrapper)"] = lambda: sp.sam_perturb(w, g, RHO, sq, out=out)
    candidates["fused_axpy (wrapper)"] = lambda: fu.fused_axpy(scale, g, w, out=out)
    alpha = float(scale)
    candidates["torch.add"] = lambda: torch.add(w, g, alpha=alpha)
    expect = ref.sam_perturb_flat_plain(w, g, RHO, sq)
    for name, fn in candidates.items():
        if name == "torch.add":
            continue
        out.zero_()
        fn()
        torch.cuda.synchronize()
        if not torch.equal(out, expect):
            raise RuntimeError(f"{name} is not bitwise the plain version")
    del expect
    order = list(candidates)
    times = {name: [] for name in order}
    for turn in (order, order[::-1], order, order[::-1]):
        for name in turn:
            times[name].append(chip_smoke.time_ms(candidates[name], 300.0))
    for name in order:
        print(json.dumps({"candidate": name, "ms": times[name]}), flush=True)
    for kernel in ("chunk_w_first", "chunk_g_first"):
        ops = memory_order(library, kernel)
        print(json.dumps({"kernel": kernel, "loads_and_stores": ops[:24]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
