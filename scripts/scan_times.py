#!/usr/bin/env python3
"""Device times of the SSD forward and the wkv backward at the models' shapes.

    python3 scripts/scan_times.py TAG

Times (CUDA events, `chip_smoke.time_ms`) the Mamba2 SSD forward at
zamba2-1.2b's descent, ascent and decode shapes (8 and 2 x 1024, and 8 x 1
from a state; 64 heads, P = N = 64, bf16), with its phases alone where the
wrapper has them (`mamba2_scan.FWD_PHASES`), and the wkv backward at
rwkv6-7b's shape (8 x 1024, 64 heads of 64, bf16), a decode step and K = V =
16 in fp32. It imports the checkout it is run from (its `src` and its
`chip_smoke.py`), so two trees compare in one call on one card: unpack the
other tree with `git archive` into a directory `.gitignore` lists, and run
the script from each root in turns (parent, change, change, parent). Prints
TAG and one JSON object of milliseconds. Needs one NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path.cwd()
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

M2_SHAPES = {"m2 B8": ((8, 1024, 64, 64, 64, 1), False), "m2 B2": ((2, 1024, 64, 64, 64, 1), False),
             "m2 decode": ((8, 1, 64, 64, 64, 1), True)}
WKV_SHAPES = {"wkv bwd": ((8, 1024, 64, 64, 64), "bfloat16", False),
              "wkv bwd decode": ((8, 1, 64, 64, 64), "bfloat16", True),
              "wkv bwd K16 fp32": ((8, 1024, 4, 16, 16), "float32", True)}


def main() -> int:
    import torch

    import chip_smoke as c
    from repro_torch.kernels import build
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import rwkv6_scan as r6

    if not torch.cuda.is_available():
        raise SystemExit("scan_times: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build([m2.SOURCE, r6.SOURCE])
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
    for name, (shape, dtype, init) in WKV_SHAPES.items():
        r, k, v, w, u, s0 = c.wkv_inputs(shape, dtype, init)
        g = torch.Generator(device="cuda").manual_seed(4)
        dy = torch.randn(r.shape[:3] + (shape[4],), generator=g, device="cuda").to(r.dtype)
        ds = torch.randn((shape[0], shape[2], shape[3], shape[4]), generator=g, device="cuda")
        out[name] = c.time_ms(lambda: r6._launch_bwd(r, k, v, w, u, s0, dy, ds))
    print(sys.argv[1] if len(sys.argv) > 1 else "tree", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
