#!/usr/bin/env python3
"""Where the flash-attention forward's wgmma path spends its time, on the card.

    python3 scripts/flash_ablation.py

Builds variants of `src/repro_torch/csrc/flash_attention.cu` that each take
one part out (the source is rewritten at fixed anchors into
`build/flash_ablation/`; a missing anchor fails the run) and times each at
olmo-1b's and zamba2's prefill shapes (8 x 1024, causal and not, bf16):

  full          the kernel as it is
  no_products   neither wgmma is issued: loads, barriers and the softmax
  no_softmax    the softmax is skipped: loads, barriers and both products
  loads_only    neither: the TMA loads and the barriers alone
  no_turns      the consumer warpgroups do not take turns to issue products
  heads_first   CTAs launch with (b, h) varying fastest, so the resident CTAs
                read different heads' K and V
  one_stage     S and P V share one wgmma stage (no fence before P V)
  rolled_k      the k steps of S = Q K^T run as a loop, not unrolled
  divergent     the warpgroup's role read from threadIdx, not made
                warp-uniform with a shuffle

A variant's output is not a result (it skips work); only its time is read.
Prints the card (nvidia-smi), one JSON line per variant and shape, and for
each variant the ptxas warnings that say it serializes every wgmma (C7514,
C7515, C7518: non-wgmma code inside a wgmma pipeline stage, or a divergent
path). Needs one NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SHAPES = {"olmo-1b prefill": (8, 1024, 1024, 16, 16, 128, 128),
          "zamba2 prefill": (8, 1024, 1024, 32, 32, 64, 64)}

SKIP_PRODUCTS = [("  for (int ks = 0; ks < 4 * D; ++ks) {", "  for (int ks = 0; ks < 0; ++ks) {"),
                 ("  for (int kk = 0; kk < BKV / 16; ++kk)\n#pragma unroll\n    for (int n = 0; n < D",
                  "  for (int kk = 0; kk < 0; ++kk)\n#pragma unroll\n    for (int n = 0; n < D")]
SKIP_SOFTMAX = [("                                             float sl2, const Params& p) {\n",
                 "                                             float sl2, const Params& p) {\n"
                 "  alpha[0] = alpha[1] = 1.f;\n  return;\n")]
NO_TURNS = [("__device__ __forceinline__ void consumers_sync(int id) {\n",
             "__device__ __forceinline__ void consumers_sync(int id) {\n  return;\n"),
            ("__device__ __forceinline__ void consumers_arrive(int id) {\n",
             "__device__ __forceinline__ void consumers_arrive(int id) {\n  return;\n")]
HEADS_FIRST = [("  const int bh = blockIdx.x / n_pairs;\n  const int pair = blockIdx.x - bh * n_pairs;\n",
                "  const int bh = blockIdx.x % (p.B * p.H);\n  const int pair = blockIdx.x / (p.B * p.H);\n")]
ONE_STAGE = [("  constexpr uint32_t KV_BLOCK = BKV * wg::ROW_BYTES;\n  wgmma_fence();\n",
              "  constexpr uint32_t KV_BLOCK = BKV * wg::ROW_BYTES;\n")]
ROLLED_K = [("#pragma unroll\n  for (int ks = 0; ks < 4 * D; ++ks) {",
             "#pragma unroll 1\n  for (int ks = 0; ks < 4 * D; ++ks) {")]
DIVERGENT = [("  const int wg_idx = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);",
              "  const int wg_idx = static_cast<int>(threadIdx.x) / 128;")]
VARIANTS = {"full": [], "no_products": SKIP_PRODUCTS, "no_softmax": SKIP_SOFTMAX,
            "loads_only": SKIP_PRODUCTS + SKIP_SOFTMAX, "no_turns": NO_TURNS,
            "heads_first": HEADS_FIRST, "one_stage": ONE_STAGE, "rolled_k": ROLLED_K,
            "divergent": DIVERGENT}
SERIALIZED = ("C7514", "C7515", "C7518")


def variant_sources() -> dict[str, pathlib.Path]:
    from repro_torch.kernels import flash_attention as fa
    base = fa.SOURCE.read_text()
    out_dir = ROOT / "build" / "flash_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, edits in VARIANTS.items():
        src = base
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: anchor not found once in {fa.SOURCE}: {old!r}")
            src = src.replace(old, new)
        paths[name] = out_dir / f"fa_{name}.cu"
        paths[name].write_text(src)
    return paths


def main() -> int:
    import torch

    import chip_smoke
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("flash_ablation: needs an NVIDIA GPU")
    print(chip_smoke.nvidia_smi(), flush=True)
    paths = variant_sources()
    libs = build.build(list(paths.values()))
    for name, path in paths.items():
        log = libs[path].with_name(libs[path].name + ".log").read_text()
        print(json.dumps({"variant": name, "wgmma_serialized_warnings":
                          sorted({c for c in SERIALIZED if c in log})}), flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    for shape_name, shape in SHAPES.items():
        b, sq, sk, h, kv, hd, hd_v = shape
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
                   for s in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd_v)))
        out = torch.empty((b, sq, h, hd_v), dtype=torch.bfloat16, device="cuda")
        for name, path in paths.items():
            lib = ctypes.CDLL(str(libs[path]))
            lib.fa_fwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                                   + [ctypes.c_int64] * 12
                                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p])

            def call(causal: int) -> None:
                rc = lib.fa_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, 1,
                                b, sq, sk, h, kv, hd, hd_v, *q.stride()[:3], *k.stride()[:3],
                                *v.stride()[:3], *out.stride()[:3], hd ** -0.5, causal, 0, 0,
                                stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: launch failed, CUDA error {rc}")

            row = dict(shape=shape_name, variant=name,
                       causal_ms=chip_smoke.time_ms(lambda: call(1)),
                       noncausal_ms=chip_smoke.time_ms(lambda: call(0)))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
