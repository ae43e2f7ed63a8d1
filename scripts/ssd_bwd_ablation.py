#!/usr/bin/env python3
"""Where the Mamba2 SSD backward's phases spend their time, on the card.

    python3 scripts/ssd_bwd_ablation.py

Builds variants of `src/repro_torch/csrc/mamba2_scan.cu` that each take one
part out or change one thing (the source is rewritten at fixed anchors into
`build/ssd_bwd_ablation/`; a missing anchor fails the run) and times the
backward's phases launched alone (CUDA events) at zamba2-1.2b's descent and
ascent scan shapes (8 and 2 x 1024, 64 heads, P = N = 64, bf16):

  full          the kernels as they are
  no_products   no MMA is issued (phases A and C): staging, the elementwise
                work, the sums and the stores
  hi_only       one MMA per product (hi x hi): the split operands' extra MMAs
                left out
  tf32_mma      the products as m16n8k8 TF32 MMAs (the fp32 inputs' path)
                in place of m16n8k16 bf16 ones
  loads_only    phase C returns once its tiles are staged and cum is summed
  no_prefix     phase C skips W's row prefix sums of R and their shuffles
  unroll_k2     the k loop of every product unrolled twice
  no_partials   phase C stores no per-head db / dc partials (their values
                are kept alive, not written)
  no_seg_exp    phase C takes exp(cum_t - cum_s) as 1 (no difference, no
                expf)

A variant's output is not a result (it skips work); only its time is read.
Prints the card (nvidia-smi) and one JSON line per variant and shape. Needs
one NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SHAPES = {"zamba2 descent": (8, 1024, 64, 64, 64, 1), "zamba2 ascent": (2, 1024, 64, 64, 64, 1)}

K_LOOP = "  for (int k = k0; k < k1; k += BF ? 16 : 8) {"
VARIANTS = {
    "full": [],
    "no_products": [(K_LOOP, "  for (int k = k0; k < k0; k += BF ? 16 : 8) {")],
    "hi_only": [("        if constexpr (SB) mma_bf16(acc[j], ah, bl);\n", ""),
                ("        if constexpr (SA) mma_bf16(acc[j], al, bh);\n", "")],
    "tf32_mma": [("  constexpr bool BF = bf16_inputs<E>();\n", "  constexpr bool BF = false;\n")],
    "loads_only": [("  const float total = stotal;\n",
                    "  return;\n  const float total = stotal;\n")],
    "no_prefix": [("for (int rh = 0; rh < 2; ++rh) {", "for (int rh = 0; rh < 0; ++rh) {")],
    "unroll_k2": [(K_LOOP, "#pragma unroll 2\n" + K_LOOP)],
    "no_partials": [(f"          store_pair({part}, ((tok0 + {r}) * H + tl.h) * N + n, "
                     "a1[j][2 * hf] + st0,\n"
                     "                     a1[j][2 * hf + 1] + st1, n, N);",
                     "          dd_acc += 0.f * (a1[j][2 * hf] + st0"
                     " + a1[j][2 * hf + 1] + st1);")
                    for part, r in (("dc_part", "t"), ("db_part", "s"))],
    "no_seg_exp": [("          const float l = seg_exp(cum, t, s);",
                    "          const float l = 1.f;")],
}
PHASES = ("chunk", "carry", "grad", "reduce")


def variant_sources() -> dict[str, pathlib.Path]:
    from repro_torch.kernels import mamba2_scan as m2
    base = m2.SOURCE.read_text()
    out_dir = ROOT / "build" / "ssd_bwd_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, edits in VARIANTS.items():
        src = base
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: anchor not found once in {m2.SOURCE}: {old!r}")
            src = src.replace(old, new)
        paths[name] = out_dir / f"ssd_{name}.cu"
        paths[name].write_text(src)
    return paths


def main() -> int:
    import torch

    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import mamba2_scan as m2

    if not torch.cuda.is_available():
        raise SystemExit("ssd_bwd_ablation: needs an NVIDIA GPU")
    print(chip_smoke.nvidia_smi(), flush=True)
    paths = variant_sources()
    libs = build.build(list(paths.values()))
    stream = torch.cuda.current_stream().cuda_stream
    for shape_name, shape in SHAPES.items():
        x, dt, a, b, c, d, s0 = chip_smoke.m2_inputs(shape, "bfloat16", False, False)
        gen = torch.Generator(device="cuda").manual_seed(6)
        dy = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
        ds = torch.randn((shape[0], shape[2], shape[3], shape[4]), generator=gen, device="cuda")
        bufs = m2.bwd_buffers(x, b)
        bsz, s, h, p = x.shape
        ptrs = [t.data_ptr() for t in (x, dt, a, b, c, d)] + [None, dy.data_ptr(), ds.data_ptr()]
        ptrs += [bufs[k].data_ptr() for k in ("dx", "ddt", "db", "dc", "da", "dd", "ds0", "hbuf",
                                              "gbuf", "etot", "db_part", "dc_part", "da_part",
                                              "dd_part")]
        for name, path in paths.items():
            lib = ctypes.CDLL(str(libs[path]))
            lib.mamba2_bwd.argtypes = ([ctypes.c_void_p] * 23 + [ctypes.c_int] * 8
                                       + [ctypes.c_void_p])

            def call(bits: int) -> None:
                rc = lib.mamba2_bwd(*ptrs, 1, bsz, s, h, b.shape[2], p, b.shape[3], bits, stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: launch failed, CUDA error {rc}")

            call(m2.BWD_ALL)
            row = dict(shape=shape_name, variant=name)
            row.update({f"{ph}_ms": chip_smoke.time_ms(lambda bit=m2.BWD_PHASES[ph]: call(bit))
                        for ph in PHASES})
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
