#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit), torch and CUDA versions;
2. builds every kernel of the serving path from `src/repro_torch/csrc`;
3. kernel phase: runs each kernel on the card at the serving path's shapes
   and at edge shapes, holds it against its plain PyTorch version, and times
   kernel, plain version and the PyTorch library call that computes the same
   function (a yardstick only; the port never calls it);
4. serve phase: full-width olmo-1b (bf16 compute, fp32 weights from seed 0)
   serves 8 requests x 1024 prompt tokens + 32 greedy tokens through
   `repro_torch.launch.serve.serve`; the launch counts, set to 0 just before
   and read just after, show the path went through the kernels; then
   prefill + stepwise decode logits are held against one full forward, and
   the kernel path against the plain path on the same weights, in bf16 and
   in fp32 compute;
5. prints the device time by kernel over one prefill and four decode
   steps (torch.profiler) and the device's busy share;
6. prints the kernels' JSON line and, last, {"ok": true, "device": {...}}.

Any failure raises and exits nonzero before the last line. Without CUDA, or
without the repository beside it, it exits nonzero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense tensor-core bf16; fp32 non-tensor
BF16_TOL = dict(rtol=2e-2, atol=2e-2)           # the reference's kernel tolerances
FP32_TOL = dict(rtol=2e-5, atol=2e-5)
# Logits of full-width olmo-1b, compared as max|a - b| / max|b|. In bf16 the
# residual stream is rounded at every one of the 16 layers, and two paths
# that round in other places drift apart by about as much as bf16 is from
# fp32 itself (about 3e-2 here: the "bf16 error itself" line below).
MODEL_BF16_REL_TOL = 5e-2
# In fp32 compute only the order of summation differs.
MODEL_FP32_REL_TOL = 1e-4


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def time_ms(fn, min_total_ms: float = 200.0) -> float:
    """Mean device time of fn() over enough back-to-back calls (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    reps = 1
    while True:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        total = start.elapsed_time(end)
        if total >= min_total_ms or reps >= 256:
            return total / reps
        reps = min(256, max(reps * 2, int(reps * min_total_ms / max(total, 1e-3)) + 1))


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # name, (B, Sq, Sk, H, K, hd, hd_v), dtype, causal, window, offset: q/k/v are
    # views at this element offset into wider rows (1 breaks the 16-byte row
    # alignment, which sends a bf16 call down the CUDA-core path)
    ("olmo-1b prefill", (8, 1024, 1024, 16, 16, 128, 128), "bfloat16", True, None, 0),
    ("olmo-1b prefill, unaligned", (8, 1024, 1024, 16, 16, 128, 128), "bfloat16", True,
     None, 1),
    ("GQA", (2, 256, 256, 8, 2, 64, 64), "bfloat16", True, None, 0),
    ("MQA hd128", (2, 512, 512, 16, 1, 128, 128), "bfloat16", True, None, 0),
    ("window 64", (2, 256, 256, 4, 4, 64, 64), "bfloat16", True, 64, 0),
    ("non-causal", (2, 256, 256, 4, 4, 64, 64), "bfloat16", False, None, 0),
    ("ragged S=1000", (2, 1000, 1000, 8, 8, 128, 128), "bfloat16", True, None, 0),
    ("ragged S=37", (4, 37, 37, 16, 16, 128, 128), "bfloat16", True, None, 0),
    ("hd_v != hd", (2, 128, 128, 4, 4, 48, 32), "bfloat16", True, None, 0),
    ("bf16 hd 40", (2, 256, 256, 4, 2, 40, 40), "bfloat16", True, None, 0),
    ("fp32", (2, 256, 256, 4, 2, 64, 64), "float32", True, None, 0),
]


def visible_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs the mask lets through: the work this input needs."""
    total = 0
    for qi in range(sq):
        hi = min(sk, qi + 1) if causal else sk
        lo = max(0, qi - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def flash_bound(shape, dtype: str, causal: bool, window) -> tuple[float, str]:
    b, sq, sk, h, kv, hd, hd_v = shape
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = elem * (b * sq * h * hd + b * sk * kv * (hd + hd_v) + b * sq * h * hd_v)
    flops = 2 * (hd + hd_v) * b * h * visible_pairs(sq, sk, causal, window)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_call(q, k, v, causal: bool, window):
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    if window is None:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                      enable_gqa=gqa)
    qpos = torch.arange(q.shape[1], device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = (qpos - kpos < window) & ((qpos >= kpos) if causal else True)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=gqa)


def flash_phase() -> dict:
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    main_case, failures = None, []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, shape, dtype, causal, window, offset in FLASH_CASES:
        b, sq, sk, h, kv, hd, hd_v = shape
        tdt = getattr(torch, dtype)
        q, k, v = (torch.randn((*s[:-1], s[-1] + offset), generator=gen,
                               device="cuda").to(tdt)[..., offset:]
                   for s in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd_v)))
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        expect = ref.flash_attention_plain(q, k, v, causal=causal, window=window)
        tol = BF16_TOL if dtype == "bfloat16" else FP32_TOL
        diff = (out.float() - expect.float()).abs()
        err = float(diff.max())
        ok = (out.shape == expect.shape and bool(torch.isfinite(out).all())
              and bool((diff <= tol["atol"] + tol["rtol"] * expect.float().abs()).all()))
        ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal, window=window))
        plain_ms = time_ms(lambda: ref.flash_attention_plain(q, k, v, causal=causal,
                                                             window=window))
        library_ms = time_ms(sdpa_call(q, k, v, causal, window))
        bound_ms, bound_by = flash_bound(shape, dtype, causal, window)
        path = "tensor cores" if fa.uses_tensor_cores(q, k, v) else "CUDA cores"
        row = dict(case=name, shape=shape, dtype=dtype, causal=causal, window=window,
                   path=path, max_abs_err=err, atol=tol["atol"], rtol=tol["rtol"], ok=ok, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        print("flash_attention " + json.dumps(row))
        if not ok:
            failures.append(name)
        if main_case is None:
            main_case = row
    if failures:
        fail(f"flash_attention kernel disagrees with its plain version: {failures}")
    return main_case


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------

def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) / float(b.float().abs().max())


def serve_phase():
    """Serve full-width olmo-1b through the kernels and check the logits.
    Returns (summary dict, model)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenTask
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model, transformer

    n_req, prompt_len, max_new = 8, 1024, 32
    cfg = get_config("olmo-1b")
    t0 = time.perf_counter()
    model = build_model(cfg).init(seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"olmo-1b init on the card: {time.perf_counter() - t0:.3f}s, "
          f"{sum(p.numel() for p in model.parameters())} params ({cfg.param_dtype}), "
          f"compute {cfg.compute_dtype}")
    prompts = TokenTask(cfg.vocab_size, seed=0).sample(n_req, prompt_len)
    serve(cfg, model, prompts, 2)                         # warm-up, not counted

    fa.launches = 0                                       # counts: 0 just before
    torch.cuda.reset_peak_memory_stats()
    res = serve(cfg, model, prompts, max_new)
    launches = {"flash_attention": fa.launches}           # read just after
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"serve: prefill {n_req}x{prompt_len} in {res.prefill_s:.4f}s "
          f"({res.prefill_tok_s:.1f} tok/s); decode {max_new - 1} steps in "
          f"{res.decode_s:.4f}s ({res.decode_tok_s:.1f} tok/s); peak {peak_gib:.2f} GiB; "
          f"launches {launches}")
    if launches["flash_attention"] != cfg.n_layers:
        fail(f"flash_attention launched {launches['flash_attention']} times in one "
             f"prefill, expected n_layers={cfg.n_layers}")
    if res.tokens.shape != (n_req, max_new) or res.logits.shape != (n_req, max_new,
                                                                     cfg.vocab_size):
        fail(f"unexpected output shapes {tuple(res.tokens.shape)} {tuple(res.logits.shape)}")
    if not bool(torch.isfinite(res.logits).all()):
        fail("non-finite logits")

    # prefill + stepwise decode == one full forward over the same tokens
    full_tokens = torch.cat([torch.as_tensor(prompts, device="cuda").long(),
                             res.tokens[:, :-1]], dim=1)
    with torch.inference_mode():
        full, _ = transformer.forward(model, {"tokens": full_tokens}, cfg)
    err_fwd = rel_err(res.logits, full[:, prompt_len - 1:])
    del full
    # kernel path vs plain path on the same weights and prompts, in bf16 and
    # in fp32 compute; the fp32 plain path is the yardstick of bf16's own error
    tokens = torch.as_tensor(prompts, device="cuda")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")

    def prefill_logits(c, impl):
        ops.set_default_impl(impl)
        try:
            with torch.inference_mode():
                return transformer.prefill(model, {"tokens": tokens}, c)[0][:, -1]
        finally:
            ops.set_default_impl(None)

    plain16, plain32 = prefill_logits(cfg, "plain"), prefill_logits(cfg32, "plain")
    kernel32 = prefill_logits(cfg32, "kernel")
    err_plain = rel_err(res.logits[:, 0], plain16)
    err_fp32 = rel_err(kernel32, plain32)
    print(f"serve check (max|d|/max|ref|): prefill+decode vs forward {err_fwd:.3e}; "
          f"kernel vs plain prefill {err_plain:.3e} (tolerance {MODEL_BF16_REL_TOL}); "
          f"fp32 compute kernel vs plain {err_fp32:.3e} (tolerance {MODEL_FP32_REL_TOL}); "
          f"bf16 error itself: bf16 plain vs fp32 plain {rel_err(plain16, plain32):.3e}, "
          f"bf16 kernel vs fp32 plain {rel_err(res.logits[:, 0], plain32):.3e}")
    if not (err_fwd <= MODEL_BF16_REL_TOL and err_plain <= MODEL_BF16_REL_TOL
            and err_fp32 <= MODEL_FP32_REL_TOL):
        fail("serving logits disagree")
    return dict(launches=launches, prefill_s=res.prefill_s, decode_s=res.decode_s,
                prefill_tok_s=res.prefill_tok_s, decode_tok_s=res.decode_tok_s,
                peak_gib=peak_gib, err_forward=err_fwd, err_plain=err_plain,
                err_fp32=err_fp32, requests=n_req, prompt_len=prompt_len,
                max_new=max_new), model


def profile_phase(model) -> None:
    """Device time by kernel over one full-width prefill and 4 decode steps
    (torch.profiler), and the device's busy share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.synthetic import TokenTask
    from repro_torch.models import transformer

    cfg = model.cfg
    tokens = torch.as_tensor(TokenTask(cfg.vocab_size, seed=0).sample(8, 1024),
                             device="cuda")
    for phase in ("prefill", "decode"):
        with torch.inference_mode():
            logits, cache = transformer.prefill(model, {"tokens": tokens}, cfg, pad_to=1060)
            tok = logits[:, -1].argmax(-1)[:, None]
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if phase == "prefill":
                    transformer.prefill(model, {"tokens": tokens}, cfg, pad_to=1060)
                else:
                    for _ in range(4):
                        logits, cache = transformer.decode(model, cache, {"tokens": tok}, cfg)
                        tok = logits[:, -1].argmax(-1)[:, None]
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
        by_name: dict[str, list] = {}
        for e in prof.events():                 # device-side kernels only
            if e.device_type == DeviceType.CUDA:
                tot = by_name.setdefault(e.name, [0.0, 0])
                tot[0] += e.time_range.elapsed_us()
                tot[1] += 1
        busy_us = sum(t for t, _ in by_name.values())
        print(f"profile {phase}: wall {wall_us:.1f} us, device kernels {busy_us:.1f} us "
              f"(busy {100 * busy_us / wall_us:.1f}%), {len(by_name)} kernel names")
        for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
            print(f"  {t:12.1f} us {100 * t / busy_us:5.1f}%  {n:5d}x  {name[:110]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run this script "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False         # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    libs = build.build([fa.SOURCE])
    print(f"build: {len(libs)} kernel source(s) in {time.perf_counter() - t0:.2f}s")
    for src, lib in libs.items():
        log = lib.with_name(lib.name + ".log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {src.name}: {line.strip()}")

    flash = flash_phase()
    served, model = serve_phase()
    print("serve " + json.dumps(served))
    profile_phase(model)
    del model

    kernels = [dict(name="flash_attention", route="cuda",
                    source="src/repro_torch/csrc/flash_attention.cu",
                    replaces="src/repro/kernels/flash_attention.py:36",
                    launches=served["launches"]["flash_attention"],
                    max_abs_err=flash["max_abs_err"], ms=flash["ms"],
                    plain_ms=flash["plain_ms"], bound_ms=flash["bound_ms"],
                    bound_by=flash["bound_by"], library_ms=flash["library_ms"])]
    for k in kernels:
        if k["launches"] < 1:
            fail(f"{k['name']} was not launched on the main path")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
