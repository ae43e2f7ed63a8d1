#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit), torch and CUDA versions;
2. builds every kernel of the serving and training paths from
   `src/repro_torch/csrc`, one nvcc per source, all at once;
3. epilogue kernel phase: sq_norm, sam_perturb, fused_axpy, fused_dot_norms,
   adamw_epilogue and sgd_epilogue (with and without momentum, Nesterov
   and weight decay) at olmo-1b's parameter bucket (1,176,764,416 fp32
   elements) and at edge sizes, held against their plain versions and timed
   beside their bound and one PyTorch library call (a yardstick only; the
   port never calls it); fused_axpy also held to the sweep's 1,024
   elements a CTA and sq_norm to its sweep's 4,096 elements a tile and the
   same bits on a rerun; sq_norm and its library call also timed in turns,
   7 rounds each (medians, spread, which is faster beyond it); the two
   epilogues also with the numerics guard's flag at 0 (w, mu, nu and m must
   stay as they were, bit for bit; timed as `skip_ms`) before the checked
   call at 1;
4. flash kernel phase: the same for the flash-attention forward (olmo-1b's,
   zamba2's, gemma-2b's (8 heads of 256 on one kv head), qwen3-8b's (32/8
   heads of 128) and qwen2.5-32b's (40/8) prefill shapes, GQA, MQA, ragged,
   windowed, non-causal,
   MLA's hd 192 / hd_v 128, and the CUDA-core path's fp32, hd 40 and
   unaligned cases), each case also held to the kernel path it must take:
   wgmma (TMA + wgmma) for every shape of the model paths;
5. serve phase: full-width olmo-1b (bf16 compute, fp32 weights from seed 0)
   serves 8 requests x 1024 prompt tokens + 32 greedy tokens through
   `repro_torch.launch.serve.serve`; the launch counts, set to 0 just before
   and read just after, show the path went through the kernel; then
   prefill + stepwise decode logits are held against one full forward, and
   the kernel path against the plain path on the same weights, in bf16 and
   in fp32 compute; then the device time by kernel over one prefill and
   four decode steps (torch.profiler);
6. train phase: full-width olmo-1b trains 6 AsyncSAM steps (AdamW, global
   batch 8 x 1024, b' = 2) through `FusedExecutor` + `Engine`, the CLI's
   code; the counts, set to 0 just before and read just after, show each
   epilogue kernel launched once per step and the flash forward on every
   forward pass; one step is profiled; then two checks of 3 steps from one
   init: at the train phase's lr each epilogue kernel call of the path
   against its plain version on the same inputs, and at a small lr the
   whole kernel path against the whole plain path; then the guard phase:
   the same model, 8 AsyncSAM AdamW steps with `guard_update` under
   `GuardedExecutor` and `Engine.fit(tracker=...)` (a strict MemorySink), the
   loss made NaN at steps 3 and 4 by a wrapper of the loss: update_skipped 1
   exactly there, w, mu and nu after each skipped step equal to their copies
   from before it bit for bit, adamw_epilogue launched once a step,
   nonfinite_count the gradient's element count, guard_state reaching 1, the
   carried ascent norm finite, the final loss finite; and the median clean
   guarded step against the train phase's unguarded median (the guard's
   cost);
7. SGD train phase: the same model trains 6 AsyncSAM steps with the paper's
   optimizer, sgd(cosine, momentum 0.9): sgd_epilogue once a step and no
   adamw_epilogue; one step is profiled; a lockstep check of 3 steps holds
   each epilogue kernel call against its plain version;
8. restart phase: olmo-1b at full width and 2 layers trains 6 SGD-momentum
   AsyncSAM steps under `Engine.fit` with a `CheckpointCallback` (save every
   3 steps, asynchronous) and a failure injected before step 4; the final
   params, momentum and carried ascent gradient must equal an uninterrupted
   run's bit for bit, with one restart and the live buffers kept; then the
   SAM path (2 steps), whose perturbation runs sq_norm + sam_perturb;
9. delta kernel phase: delta_amax and delta_encode_i8 at the epilogue
   phase's sizes (the olmo-1b bucket included), p in fp32 and bf16, and with
   a NaN and an inf in p, held to their plain versions exactly and timed;
10. remote phase (Form B across processes, the slice's main path): olmo-1b
   at full width and 6 layers (the deepest whose snapshot fits the wire's
   2 GiB frame) trains 4 lockstep SGD-momentum AsyncSAM steps through
   `RemoteExecutor(serve_ascent=True, job_compress="int8")`, its ascent server
   spawned on the card in a second process; every delta kernel call is held
   to its plain version on its inputs, the launches are counted (0 just
   before, read just after), and the client's shadow must equal a numpy
   replay of the snapshot and every int8 payload bit for bit; prints each
   exchange's bytes and times and both processes' peak memory; it runs with
   the lane ladder on and a tracker: lane_state 0 every step, the
   ascent_rpc spans counted;
11. hetero phase: olmo-1b at full width and 2 layers, the descent on the
   card and the ascent lane a CPU thread, calibrated (t_fast, t_slow, b'/b),
   then steps until a fresh ascent gradient was harvested: the tau schedule,
   stale reuses and SGD fallbacks; the lanes' spans go to a Chrome trace
   (build/hetero_trace.json) and its hidden-perturbation fraction is printed
   (`repro_torch.obs.compute_overlap`);
12. rwkv kernel phase: the wkv scan's forward and backward kernels at
   rwkv6-7b's scan shape (8 x 1024 tokens, 64 heads of 64, bf16 r/k/v, fp32
   decay and bonus), a one-token decode step from a state, a ragged S and
   K = V = 16 in fp32, held against the plain scan and autograd of it (the
   forward run twice: the same bits), and timed beside their bound; the
   forward kernel's registers and spills (ptxas) printed;
13. rwkv serve phase: full-width, full-depth rwkv6-7b (7,534,813,184 fp32
   parameters from seed 0, bf16 compute) serves 8 x 1024 prompts + 32 greedy
   tokens through `launch.serve.serve`: 32 forward launches per prefill and
   per decoded token (counts 0 just before, read just after); prefill +
   stepwise decode against one forward, the kernel path against the plain
   path in bf16 and fp32 compute; then its profile as in 5;
14. rwkv train phase: rwkv6-7b at full width and 4 layers trains 6 AsyncSAM
   AdamW steps through `FusedExecutor` + `Engine` (remat "full": 16 forward
   and 8 backward scan launches a step, each epilogue kernel once); one step
   profiled; every wkv call of one step held against its plain version on
   its inputs; the whole kernel path against the plain path at a small lr,
   2 layers, batch 2 x 512, in fp32 and bf16 compute (bf16's moments held
   by their bulk to twice the plain path's own bf16 error; a control with
   its weights at 6 bits must fail that limit);
15. mamba2 kernel phase: the SSD scan's forward and backward kernels at
   zamba2-1.2b's scan shape (8 x 1024 tokens, 64 heads, P = N = 64, one
   group, bf16 x/b/c, fp32 dt/a/d) and its ascent batch's (2 x 1024), a
   one-token decode step from a state, a ragged S from a state, G = 2 over
   H = 4 in fp32 and a head whose decay underflows, held against the plain
   scan and autograd of it (da against the scan in float64; each kernel run
   twice: bit for bit the same), timed beside their bound, the forward's
   three phases and the backward's four also each alone;
16. zamba2 serve phase: full-width, full-depth zamba2-1.2b (1,177,813,888
   fp32 parameters from seed 0, bf16 compute; 38 mamba layers, 7 invocations
   of the shared attention block) serves 8 x 1024 prompts + 32 greedy tokens
   through `launch.serve.serve`: 38 scans and 7 flash launches a prefill, 38
   scans a decoded token (counts 0 just before, read just after); the checks
   and profile of 13;
17. zamba2 train phase: zamba2-1.2b at full width and depth trains 6
   AsyncSAM AdamW steps through `FusedExecutor` + `Engine` (remat "full" on
   the mamba blocks: 152 forward and 76 backward scan launches and 14 flash
   launches a step, each epilogue kernel once); one step profiled; every SSD
   call of one step held against its plain version on its inputs (da
   against the scan in float64); the whole kernel path against the plain
   path at a small lr, 8 layers, batch 2 x 512, in fp32 and bf16 compute
   (bf16's moments held and controlled as rwkv6's);
18. dense serve phases: gemma-2b and qwen3-8b at full depth, qwen2.5-32b at
   the deepest cut whose fp32 weights leave 16 GiB of the card, each serving
   8 x 1024 prompts + 32 greedy tokens through `launch.serve.serve` (fp32
   weights from seed 0, bf16 compute): n_layers flash launches a prefill
   (counts 0 just before, read just after); prefill + stepwise decode against
   one forward and the kernel path against the plain path, both held to
   twice bf16's own error on the model's weights (the plain path in bf16
   against it in fp32), fp32 compute to 1e-4; the profile of 5; then a
   control, the kernel path with its weights at 6 bits, must exceed that
   limit;
19. dense train phases: gemma-2b and qwen3-8b at full width and the deepest
   depth whose step, extrapolated from one step at 1 and at 2 layers, leaves
   10% of the card, train 6 AsyncSAM AdamW steps through `FusedExecutor` +
   `Engine`: each epilogue kernel once a step, flash on every forward; one
   step profiled; the lockstep check of one step at half that depth;
20. variants phase: full-width, full-depth olmo-1b trains gsam (3 steps,
   bucket-resident), looksam (k 2: fresh, reuse, fresh, reuse), esam (3),
   aesam (10: 8 forced SAM steps, then its z decides) and mesa (4, the term
   on from step 2) on per-leaf state, as the launcher builds them; every
   step's launches of sq_norm, sam_perturb, fused_axpy, fused_dot_norms,
   adamw_epilogue and flash held to its branch's; step time, peak memory,
   the state each carries, one step profiled (its copies and host reads:
   AE-SAM's z); every weight-space kernel call of one gsam step and of a
   looksam fresh and reuse step against its plain version;
21. prints the kernels' JSON line and, last, {"ok": true, "device": {...}}.

Any failure raises and exits nonzero before the last line. Without CUDA, or
without the repository beside it, it exits nonzero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
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
    # name, (B, Sq, Sk, H, K, hd, hd_v), dtype, causal, window, offset, path:
    # q/k/v are views at this element offset into wider rows (1 breaks the
    # 16-byte row alignment, which sends a bf16 call down the CUDA-core path);
    # `path` is the kernel path the case must take ("wgmma" for every shape
    # of the model paths, the run fails otherwise)
    ("olmo-1b prefill", (8, 1024, 1024, 16, 16, 128, 128), "bfloat16", True, None, 0, "wgmma"),
    ("zamba2 prefill", (8, 1024, 1024, 32, 32, 64, 64), "bfloat16", True, None, 0, "wgmma"),
    ("gemma-2b prefill", (8, 1024, 1024, 8, 1, 256, 256), "bfloat16", True, None, 0, "wgmma"),
    ("qwen3-8b prefill", (8, 1024, 1024, 32, 8, 128, 128), "bfloat16", True, None, 0, "wgmma"),
    ("qwen2.5-32b prefill", (8, 1024, 1024, 40, 8, 128, 128), "bfloat16", True, None, 0,
     "wgmma"),
    ("olmo-1b prefill, unaligned", (8, 1024, 1024, 16, 16, 128, 128), "bfloat16", True,
     None, 1, "cuda_cores"),
    ("GQA", (2, 256, 256, 8, 2, 64, 64), "bfloat16", True, None, 0, "wgmma"),
    ("MQA hd128", (2, 512, 512, 16, 1, 128, 128), "bfloat16", True, None, 0, "wgmma"),
    ("window 64", (2, 256, 256, 4, 4, 64, 64), "bfloat16", True, 64, 0, "wgmma"),
    ("non-causal", (2, 256, 256, 4, 4, 64, 64), "bfloat16", False, None, 0, "wgmma"),
    ("ragged S=1000", (2, 1000, 1000, 8, 8, 128, 128), "bfloat16", True, None, 0, "wgmma"),
    ("ragged S=37", (4, 37, 37, 16, 16, 128, 128), "bfloat16", True, None, 0, "wgmma"),
    ("MLA hd 192 / hd_v 128", (2, 1024, 1024, 16, 16, 192, 128), "bfloat16", True, None, 0,
     "wgmma"),
    ("hd_v != hd", (2, 128, 128, 4, 4, 48, 32), "bfloat16", True, None, 0, "wgmma"),
    ("bf16 hd 40", (2, 256, 256, 4, 2, 40, 40), "bfloat16", True, None, 0, "cuda_cores"),
    ("fp32", (2, 256, 256, 4, 2, 64, 64), "float32", True, None, 0, "cuda_cores"),
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
    """Each FLASH_CASES entry against the plain version, timed beside SDPA and
    its bound; fails when a case disagrees or takes another path than its
    own. Returns the first (olmo-1b prefill) case's row."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    main_case, failures = None, []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, shape, dtype, causal, window, offset, want_path in FLASH_CASES:
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
        path = fa.kernel_path(q, k, v)
        ok = (out.shape == expect.shape and bool(torch.isfinite(out).all())
              and bool((diff <= tol["atol"] + tol["rtol"] * expect.float().abs()).all())
              and path == want_path)
        ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal, window=window))
        plain_ms = time_ms(lambda: ref.flash_attention_plain(q, k, v, causal=causal,
                                                             window=window))
        library_ms = time_ms(sdpa_call(q, k, v, causal, window))
        bound_ms, bound_by = flash_bound(shape, dtype, causal, window)
        row = dict(case=name, shape=shape, dtype=dtype, causal=causal, window=window,
                   path=path, want_path=want_path, max_abs_err=err, atol=tol["atol"],
                   rtol=tol["rtol"], ok=ok, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        print("flash_attention " + json.dumps(row))
        if not ok:
            failures.append(name)
        if main_case is None:
            main_case = row
    if failures:
        fail(f"flash_attention kernel disagrees with its plain version or takes another "
             f"path than its case's: {failures}")
    return main_case


# ---------------------------------------------------------------------------
# epilogue kernel phase
# ---------------------------------------------------------------------------

OLMO_1B_BUCKET = 1_176_764_416        # fp32 parameters of olmo-1b: one dtype bucket
EPILOGUE_CASES = [
    # name, n, dtype of y / w (x, g, mu, nu are fp32), element offset of
    # every operand (1 breaks 16-byte alignment: the element-by-element path)
    ("olmo-1b bucket", OLMO_1B_BUCKET, "float32", 0),
    ("3 chunks + 17", 3 * 65536 + 17, "float32", 0),
    ("n=1", 1, "float32", 0),
    ("n=1000", 1000, "float32", 0),
    ("n=1000 unaligned", 1000, "float32", 1),
    ("bf16 y/w", 3 * 65536 + 17, "bfloat16", 0),
]
# adamw hyperparameters per case: (weight decay, clip scale); clip < 1 scales g
ADAMW_CASES = [(0.1, 0.7), (0.0, 0.7)]
# sgd hyperparameters per case: (momentum, nesterov, weight decay); the first
# (the path's) and the fifth (the launcher's, no momentum) run at the bucket
SGD_CASES = [(0.9, False, 0.0), (0.9, True, 0.0), (0.9, False, 1e-4), (0.9, True, 1e-4),
             (0.0, False, 0.0), (0.0, False, 1e-4)]
# ops per element: sq_norm 2, sam_perturb 2, axpy 2, dot_norms 6, adamw 16
# (clip 1, mu 3, nu 4, update 4, decay 2, apply 2); sgd's by case (sgd_ops)
EPILOGUE_OPS = {"sq_norm": 2, "sam_perturb": 2, "fused_axpy": 2, "fused_dot_norms": 6,
                "adamw_epilogue": 16}


def sgd_ops(momentum: float, nesterov: bool, wd: float) -> int:
    """clip 1, decay 2, momentum 2, Nesterov 2, lr and apply 2."""
    return 1 + (2 if wd else 0) + (2 if momentum else 0) + (2 if nesterov else 0) + 2
SWEEP_TILE = 1024                     # elements a CTA of a sweeping flat kernel
SQ_NORM_TILE = 4096                   # elements a tile of sq_norm's sweep
COMPARE_CHUNK = 1 << 27               # elements per chunk of the plain re-computation


def bound(nbytes: float, ops: float, dtype: str = "float32") -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def unchanged(got, before) -> bool:
    """Bit for bit the same tensor contents (the guard's skip)."""
    import torch
    view = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return bool(torch.equal(got.view(view), before.view(view)))


def max_rel(got, expect) -> tuple[float, float]:
    """(max|got - expect|, that over max|expect|)."""
    err = float((got.float() - expect.float()).abs().max())
    return err, err / max(float(expect.float().abs().max()), 1e-30)


# sq_norm against its library call in turns, SQ_NORM_ROUNDS rounds each: the
# two are within a few tenths of a percent of each other, less than the
# spread between calls on different cards, so only one run's turns can order
# them.
SQ_NORM_ROUNDS = 7


def sq_norm_rounds(x) -> dict:
    """sq_norm(x) and torch.linalg.vector_norm(x) ** 2 timed in turns: each
    one's median, min and max over SQ_NORM_ROUNDS rounds (ms), and which is
    faster beyond the other's spread (None: their ranges overlap)."""
    import statistics
    import torch
    from repro_torch.kernels import sam_perturb as sp
    calls = {"sq_norm": lambda: sp.sq_norm(x),
             "vector_norm_sq": lambda: torch.linalg.vector_norm(x) ** 2}
    times = {k: [] for k in calls}
    for _ in range(SQ_NORM_ROUNDS):
        for k, fn in calls.items():
            times[k].append(time_ms(fn))
    out = {k: {"median": statistics.median(v), "min": min(v), "max": max(v)}
           for k, v in times.items()}
    a, b = out["sq_norm"], out["vector_norm_sq"]
    out["faster"] = ("sq_norm" if a["max"] < b["min"] else
                     "vector_norm_sq" if b["max"] < a["min"] else None)
    print(f"sq_norm vs vector_norm(x)**2 in turns ({SQ_NORM_ROUNDS} rounds, {x.numel()} fp32): "
          f"{json.dumps(out)}")
    return out


def epilogue_phase() -> dict:
    """Each flat-buffer kernel against its plain version on the card; returns
    the olmo-1b bucket case's row per kernel."""
    import torch
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import ref
    from repro_torch.kernels import sam_perturb as sp

    gen = torch.Generator(device="cuda").manual_seed(1)
    main_rows, failures = {}, []
    # the numerics guard's verdict as the step hands it to the epilogues: a
    # 0-d fp32 device tensor, 0 (skip: nothing written) or 1 (the update)
    KEEP = (torch.zeros((), device="cuda"), torch.ones((), device="cuda"))

    def operand(n, dtype, offset, scale, positive=False):
        t = torch.empty(n + offset, dtype=torch.float32, device="cuda")
        if positive:
            t.uniform_(0.0, scale, generator=gen)
        else:
            t.normal_(0.0, scale, generator=gen)
        return t.to(getattr(torch, dtype))[offset:]

    def report(kernel, case, n, err, rel, tol, ms, plain_ms, library_ms, nbytes, dtype,
               main, ops_per_element=None, layout_ok=True, **extra):
        bound_ms, bound_by = bound(nbytes, (ops_per_element or EPILOGUE_OPS[kernel]) * n)
        ok = rel <= tol and layout_ok
        row = dict(kernel=kernel, case=case, n=n, dtype=dtype, max_abs_err=err,
                   max_rel_err=rel, rel_tol=tol, ok=ok, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, **extra)
        print("epilogue " + json.dumps(row))
        if not ok:
            failures.append(f"{kernel} / {case}")
        if main:
            main_rows[kernel] = row
        return row

    for ci, (case, n, dtype, offset) in enumerate(EPILOGUE_CASES):
        main = ci == 0
        ydt = getattr(torch, dtype)
        es = ydt.itemsize
        tol = FP32_TOL["rtol"] if dtype == "float32" else BF16_TOL["rtol"]
        red_tol = FP32_TOL["rtol"]              # fp32 sums, other order
        # gradient-like magnitudes
        x = operand(n, "float32", offset, 1e-3)
        y = operand(n, dtype, offset, 2e-2)

        # --- sq_norm (of the fp32 gradient) ---
        got = sp.sq_norm(x)
        torch.cuda.synchronize()
        expect = ref.sq_norm_plain(x)
        err, rel = max_rel(got, expect)
        # a rerun gives the same bits (fixed-order sums, no atomics)
        same_bits = float(sp.sq_norm(x)) == float(got)
        sq_tile = sp.sq_norm_tile()             # the reduction's sweep: 4,096 a tile
        report("sq_norm", case, n, err, rel, red_tol, time_ms(lambda: sp.sq_norm(x)),
               time_ms(lambda: ref.sq_norm_plain(x)),
               time_ms(lambda: torch.linalg.vector_norm(x) ** 2), 4 * n, "float32", main,
               layout_ok=sq_tile == SQ_NORM_TILE and same_bits, elements_per_tile=sq_tile,
               deterministic=same_bits, **({"interleaved": sq_norm_rounds(x)} if main else {}))

        # --- sam_perturb: out = w + rho x / sqrt(sq) (w = y), held exactly ---
        sq = ref.sq_norm_plain(x)
        out = torch.empty_like(y)
        sp.sam_perturb(y, x, RHO, sq, out=out)
        torch.cuda.synchronize()
        errs = [max_rel(out[i:i + COMPARE_CHUNK],
                        ref.sam_perturb_flat_plain(y[i:i + COMPARE_CHUNK],
                                                   x[i:i + COMPARE_CHUNK], RHO, sq))
                for i in range(0, n, COMPARE_CHUNK)]
        err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
        ms = time_ms(lambda: sp.sam_perturb(y, x, RHO, sq, out=out))
        del out
        scale = float(ref.sam_perturb_scale(RHO, sq, x.device))
        report("sam_perturb", case, n, err, rel, 0.0, ms,
               time_ms(lambda: ref.sam_perturb_flat_plain(y, x, RHO, sq)),
               time_ms(lambda: torch.add(y, x, alpha=scale)), n * (4 + 2 * es), dtype, main)

        # --- fused_axpy: out = y + alpha x ---
        alpha = torch.tensor(3.7, device="cuda")
        out = torch.empty_like(y)
        fu.fused_axpy(alpha, x, y, out=out)
        torch.cuda.synchronize()
        errs = [max_rel(out[i:i + COMPARE_CHUNK],
                        ref.axpy_flat_plain(alpha, x[i:i + COMPARE_CHUNK], y[i:i + COMPARE_CHUNK]))
                for i in range(0, n, COMPARE_CHUNK)]
        err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
        ms = time_ms(lambda: fu.fused_axpy(alpha, x, y, out=out))
        del out
        tile = fu.axpy_tile()                   # the sweep: 1,024 elements a CTA
        report("fused_axpy", case, n, err, rel, tol, ms,
               time_ms(lambda: ref.axpy_flat_plain(alpha, x, y)),
               time_ms(lambda: torch.add(y, x, alpha=3.7)), n * (4 + 2 * es), dtype, main,
               layout_ok=tile == SWEEP_TILE, elements_per_cta=tile)

        # --- fused_dot_norms(a = x, b = y) ---
        got = fu.fused_dot_norms(x, y)
        torch.cuda.synchronize()
        expect = ref.dot_norms_flat_plain(x, y)
        pairs = [max_rel(g_, e_) for g_, e_ in zip(got, expect)]
        # library_ms None: no one PyTorch call gives (<a,b>, |a|^2, |b|^2)
        report("fused_dot_norms", case, n, max(p[0] for p in pairs),
               max(p[1] for p in pairs), red_tol, time_ms(lambda: fu.fused_dot_norms(x, y)),
               time_ms(lambda: ref.dot_norms_flat_plain(x, y)), None, n * (4 + es), dtype,
               main)

        # --- adamw_epilogue: w (y's dtype) with fp32 g = x, mu, nu ---
        del y
        w = operand(n, dtype, offset, 2e-2)
        mu = operand(n, "float32", offset, 1e-4)
        nu = operand(n, "float32", offset, 1e-7, positive=True)
        lr, c1, c2 = (torch.tensor(v, device="cuda") for v in (1e-3, 0.19, 0.001999))
        for ai, (wd, clip) in enumerate(ADAMW_CASES if not main else ADAMW_CASES[:1]):
            clip_t = torch.tensor(clip, device="cuda")
            kw, kmu, knu = w.clone(), mu.clone(), nu.clone()
            # the guard's skip: keep 0 writes nothing, bit for bit
            fu.adamw_epilogue(kw, x, kmu, knu, clip_t, lr, c1, c2, weight_decay=wd,
                              keep=KEEP[0])
            torch.cuda.synchronize()
            skip_same = all(unchanged(a, b) for a, b in ((kw, w), (kmu, mu), (knu, nu)))
            fu.adamw_epilogue(kw, x, kmu, knu, clip_t, lr, c1, c2, weight_decay=wd,
                              keep=KEEP[1])
            torch.cuda.synchronize()
            errs = []
            for i in range(0, n, COMPARE_CHUNK):
                sl = slice(i, i + COMPARE_CHUNK)
                new = ref.adamw_epilogue_flat_plain(w[sl], x[sl], mu[sl], nu[sl], clip_t, lr,
                                                    c1, c2, weight_decay=wd)
                errs += [max_rel(k_[sl], p_) for k_, p_ in zip((kw, kmu, knu), new)]
            err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
            ms = time_ms(lambda: fu.adamw_epilogue(kw, x, kmu, knu, clip_t, lr, c1, c2,
                                                   weight_decay=wd, keep=KEEP[1]))
            skip_ms = time_ms(lambda: fu.adamw_epilogue(kw, x, kmu, knu, clip_t, lr, c1, c2,
                                                        weight_decay=wd, keep=KEEP[0]))
            del kw, kmu, knu
            plain_ms = time_ms(lambda: ref.adamw_epilogue_flat_plain(
                w, x, mu, nu, clip_t, lr, c1, c2, weight_decay=wd))
            library_ms = None
            if dtype == "float32" and offset == 0:
                p = torch.nn.Parameter(w)
                p.grad = x
                opt = torch.optim.AdamW([p], lr=1e-3, weight_decay=wd, fused=True)
                library_ms = time_ms(opt.step)
                del opt, p
            report("adamw_epilogue", f"{case}, wd {wd}, clip {clip}", n, err, rel,
                   tol if dtype == "float32" else BF16_TOL["rtol"], ms, plain_ms, library_ms,
                   n * (2 * es + 4 + 16), dtype, main and ai == 0, layout_ok=skip_same,
                   skip_unchanged=skip_same, skip_ms=skip_ms)
        del mu, nu
        torch.cuda.empty_cache()

        # --- sgd_epilogue: w (y's dtype), fp32 g = x and m, held exactly ---
        m = operand(n, "float32", offset, 1e-3)
        clip_t, lr = torch.tensor(0.7, device="cuda"), torch.tensor(1e-3, device="cuda")
        for si, (mom, nest, wd) in enumerate(SGD_CASES):
            if main and si not in (0, 4):
                continue
            kw, km = w.clone(), (m.clone() if mom else None)
            hyper = dict(momentum=mom, nesterov=nest, weight_decay=wd)
            fu.sgd_epilogue(kw, x, km, clip_t, lr, keep=KEEP[0], **hyper)
            torch.cuda.synchronize()
            skip_same = unchanged(kw, w) and (not mom or unchanged(km, m))
            fu.sgd_epilogue(kw, x, km, clip_t, lr, keep=KEEP[1], **hyper)
            torch.cuda.synchronize()
            errs = []
            for i in range(0, n, COMPARE_CHUNK):
                sl = slice(i, i + COMPARE_CHUNK)
                nw, nm = ref.sgd_epilogue_flat_plain(w[sl], x[sl], m[sl] if mom else None,
                                                     clip_t, lr, **hyper)
                errs.append(max_rel(kw[sl], nw))
                if mom:
                    errs.append(max_rel(km[sl], nm))
            err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
            ms = time_ms(lambda: fu.sgd_epilogue(kw, x, km, clip_t, lr, keep=KEEP[1], **hyper))
            skip_ms = time_ms(lambda: fu.sgd_epilogue(kw, x, km, clip_t, lr, keep=KEEP[0],
                                                      **hyper))
            del kw, km
            plain_ms = time_ms(lambda: ref.sgd_epilogue_flat_plain(
                w, x, m if mom else None, clip_t, lr, **hyper))
            library_ms = None
            if dtype == "float32" and offset == 0:
                p = torch.nn.Parameter(w.clone())
                p.grad = x
                opt = torch.optim.SGD([p], lr=1e-3, momentum=mom, nesterov=nest,
                                      weight_decay=wd, fused=True)
                library_ms = time_ms(opt.step)
                del opt, p
            row = report("sgd_epilogue", f"{case}, momentum {mom}, nesterov {nest}, wd {wd}",
                         n, err, rel, 0.0, ms, plain_ms, library_ms,
                         n * (2 * es + 4 + (8 if mom else 0)), dtype, main and si == 0,
                         sgd_ops(mom, nest, wd), layout_ok=skip_same,
                         skip_unchanged=skip_same, skip_ms=skip_ms)
            if main and si == 4:
                main_rows["sgd_epilogue, no momentum"] = row
        del x, w, m
        torch.cuda.empty_cache()
    if failures:
        fail(f"epilogue kernels disagree with their plain versions: {failures}")
    return main_rows


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
        by_name = device_time_by_kernel(prof)
        busy_us = sum(t for t, _ in by_name.values())
        print(f"profile {phase}: wall {wall_us:.1f} us, device kernels {busy_us:.1f} us "
              f"(busy {100 * busy_us / wall_us:.1f}%), {len(by_name)} kernel names")
        for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
            print(f"  {t:12.1f} us {100 * t / busy_us:5.1f}%  {n:5d}x  {name[:110]}")


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 8, 1024
ASCENT_FRACTION, RHO, LR = 0.25, 0.05, 3e-3
# the paper's optimizer, sgd(cosine_schedule(lr, steps), momentum=0.9)
# (benchmarks/common.py), at an lr that keeps the random-init loss finite
SGD_LR, SGD_MOMENTUM = 0.05, 0.9
# the kernels each optimizer's training path launches once a step
PATH_KERNELS = {"adamw": ("sq_norm", "fused_axpy", "fused_dot_norms", "adamw_epilogue"),
                "sgd": ("sq_norm", "fused_axpy", "fused_dot_norms", "sgd_epilogue")}
EPILOGUE_KERNELS = PATH_KERNELS["adamw"]
# Two training checks, 3 AsyncSAM steps each from the seed-0 init.
#
# Lockstep check, at the train phase's lr: every epilogue kernel call the path
# makes is held, as it is made, against its plain version on the same inputs:
# the sums by |d| / |plain|, fused_axpy's out and adamw_epilogue's w by
# max|d| / max|plain - before| (the step's own change: a buffer left unwritten
# misses by all of it), mu and nu by max|d| / max|plain|. The limit is the
# epilogue phase's, the reference's fp32 kernel tolerance; the elementwise
# kernels match bit for bit, the sums differ in their order only. Two whole
# runs cannot hold the kernels tightly: that order difference alone (2e-7 in
# ||a||) moves rho / ||a|| in w_hat, flips the bf16 rounding of some of its
# weights, and Adam at this lr amplifies it to 4e-3 in grad_norm by step 2
# (on an H100, PERF.md).
LOCKSTEP_REL_TOL = FP32_TOL["rtol"]
# Whole-path check, at lr 3e-5: the whole kernel path, flash forward
# included, against the whole plain path. The flash kernel rounds P to bf16
# before P V (the serve check's 2.7e-2 on logits), so per-step scalars are
# held to the bf16 model tolerance and the moments follow the gradients: mu
# (max|d| / max|mu|) to it, nu (squares) to twice it. Adam moves a weight by
# about lr a step whatever its gradient's size, so a weight whose gradient is
# at bf16 noise may move the other way on the other path: more than 0.1% of
# the weights do (on an H100, PERF.md), and max|dw| says nothing. w is held
# by its bulk: the median |dw| against the median |change| of w, where an
# unwritten w gives about 1. At the train phase's lr those flips make the two
# runs different models by step 2 (grad_norm 16% apart), hence lr 3e-5.
TRAIN_CHECK_STEPS, WHOLE_CHECK_LR = 3, 3e-5
SCALAR_REL_TOL = MODEL_BF16_REL_TOL
COSINE_ABS_TOL = MODEL_BF16_REL_TOL
MOMENT_REL_TOL = {"mu": MODEL_BF16_REL_TOL, "nu": 2 * MODEL_BF16_REL_TOL}
W_BULK_TOL = 0.1
BULK_QUANTILES = (0.5, 0.9, 0.999)  # printed; the median is held
BULK_STRIDE = 97            # subsample for quantiles (torch.quantile takes <= 2^24)


def reset_launches() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import rwkv6_scan as r6
    from repro_torch.kernels import sam_perturb as sp
    fa.launches = 0
    for counts in (sp.launches, fu.launches, r6.launches, m2.launches):
        for name in counts:
            counts[name] = 0


def flash_per_step(cfg) -> tuple[int, str]:
    """Flash launches one AsyncSAM step implies: 2 gradient passes (ascent at
    w, descent at w_hat); each runs every block's forward once, and again in
    backward when the block is checkpointed (remat "full" or "dots")."""
    fwd = 1 if cfg.remat == "none" else 2
    n = 2 * fwd * cfg.n_layers
    return n, (f"2 gradient passes x {fwd} forward(s) per block (remat={cfg.remat!r}) x "
               f"{cfg.n_layers} layers = {n}")


def build_trainer(steps: int, lr: float = LR, family: str = "adamw", cfg=None,
                  method: str = "async_sam", batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                  mkw=None, loss_wrap=None):
    """olmo-1b (full width and depth unless `cfg`) from seed 0, AsyncSAM (or
    `method`, with the MethodConfig fields `mkw`) with AdamW (what `python -m
    repro_torch.launch.train` builds) or with the paper's sgd(momentum 0.9),
    on the card, and its pipeline (an ascent sub-batch for async_sam only, as
    the launcher's). `loss_wrap(loss_fn)` replaces the model's loss."""
    from repro_torch.configs import get_config
    from repro_torch.core import MethodConfig
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.engine import FusedExecutor
    from repro_torch.models import build_model
    from repro_torch.optim import cosine_schedule, make_optimizer, sgd

    cfg = cfg or get_config("olmo-1b")
    bundle = build_model(cfg)
    if family == "adamw":
        opt = make_optimizer("adamw", cosine_schedule(lr, steps, warmup_steps=steps // 20))
    else:
        opt = sgd(cosine_schedule(lr, steps), momentum=SGD_MOMENTUM)
    ex = FusedExecutor(loss_wrap(bundle.loss_fn) if loss_wrap else bundle.loss_fn,
                       MethodConfig(name=method, rho=RHO, ascent_fraction=ASCENT_FRACTION,
                                    **(mkw or {})),
                       opt)
    state = ex.init_state(bundle.init(seed=0, device="cuda"), seed=1)
    pipe = TokenPipeline(cfg, PipelineConfig(
        global_batch=batch, seq_len=seq, seed=0,
        ascent_fraction=ASCENT_FRACTION if method == "async_sam" else 0.0), device="cuda")
    return cfg, ex, state, pipe


def train_phase(family: str = "adamw"):
    """Train full-width olmo-1b through the kernels; returns (summary,
    executor, final state, pipeline)."""
    import statistics
    import torch
    from repro_torch.engine import Engine, ThroughputMeter
    from repro_torch.launch.train import kernel_launches
    from repro_torch.optim import epilogue_hbm_bytes

    tag = "train" if family == "adamw" else f"train {family}"
    lr = LR if family == "adamw" else SGD_LR
    cfg, ex, state, pipe = build_trainer(TRAIN_STEPS, lr, family)
    n_params = sum(b.numel() for b in state.params.buffers)
    print(f"{tag}: olmo-1b {n_params} params in {len(state.params.buffers)} bucket(s) "
          f"({[g.dtype for g in state.params.layout.groups]}), compute {cfg.compute_dtype}, "
          f"remat {cfg.remat}; batch {TRAIN_BATCH} x {TRAIN_SEQ}, b' = "
          f"{max(1, round(TRAIN_BATCH * ASCENT_FRACTION))}; optimizer {family}, lr {lr}")
    meter = ThroughputMeter(tokens_per_batch=TRAIN_BATCH * TRAIN_SEQ)
    reset_launches()                                   # counts: 0 just before
    torch.cuda.reset_peak_memory_stats()
    report = Engine(ex, pipe, [meter]).fit(state, TRAIN_STEPS)
    launches = kernel_launches()                       # read just after
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for i, m in enumerate(report.metrics_history):
        print(f"{tag} step {i}: {json.dumps(m)} ({meter.step_times[i]:.4f} s)")
    flash_n, how = flash_per_step(cfg)
    print(f"{tag} launches over {TRAIN_STEPS} steps: {launches}; flash per step: {how}")
    for name, n in launches.items():
        want = (TRAIN_STEPS if name in PATH_KERNELS[family]
                else flash_n * TRAIN_STEPS if name == "flash_attention" else 0)
        if n != want:
            fail(f"{tag}: {name} launched {n} times in {TRAIN_STEPS} steps, expected {want} "
                 f"(the path's kernels once per step: one fp32 bucket)")
    hist = report.metrics_history
    if report.steps_done != TRAIN_STEPS or not all(
            math.isfinite(v) for m in hist for v in m.values()):
        fail(f"{tag}: training did not finish with finite metrics: {hist}")
    if [m["perturbed"] for m in hist] != [0.0] + [1.0] * (TRAIN_STEPS - 1):
        fail(f"perturbed should be 0 at step 0 and 1 after: {[m['perturbed'] for m in hist]}")
    if any(m["tau"] != 1.0 for m in hist):
        fail(f"tau should be 1 every step: {[m['tau'] for m in hist]}")
    step_s = statistics.median(meter.step_times[2:])
    summary = dict(optimizer=family, steps=TRAIN_STEPS, step_times_s=meter.step_times,
                   median_step_s=step_s, descent_tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
                   peak_gib=peak_gib, launches=launches, flash_per_step=flash_n,
                   loss_first=hist[0]["loss"], loss_last=hist[-1]["loss"])
    print(f"{tag}: median step (steps 2-{TRAIN_STEPS - 1}) {step_s:.4f} s, "
          f"{summary['descent_tokens_per_s']:.1f} descent tok/s, peak {peak_gib:.2f} GiB")
    # the reference's model of the epilogue's traffic (no clip, decay as the
    # optimizer has it, carried norm, resident), against the four kernels'
    # own bytes: without clip the model counts no grad-norm pass, which runs
    # every step for the grad_norm metric, and it leaves out the ascent
    # refresh's read of both fp32 ascent buffers
    model_bytes = epilogue_hbm_bytes(n_params, 4 * n_params, family=family, clip=False,
                                     weight_decay=family == "adamw", momentum=True,
                                     carried_norm=True, fused=True, resident=True)
    kernel_bytes = (4 + 12 + 8 + (28 if family == "adamw" else 20)) * n_params
    print(f"{tag}: epilogue bytes a step, reference model {model_bytes} "
          f"({model_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s), the four kernels "
          f"{kernel_bytes} ({kernel_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms)")
    return summary, ex, report.final_state, pipe


# ---------------------------------------------------------------------------
# guard phase: the numerics guard on the AdamW train path
# ---------------------------------------------------------------------------

# 8 guarded steps, a NaN loss (ascent and descent) at steps 3 and 4
GUARD_STEPS, GUARD_SKIPS = 8, (3, 4)


def guard_phase(unguarded_step_s: float) -> dict:
    """Full-width olmo-1b, Form A AsyncSAM with AdamW under `GuardedExecutor`
    and `Engine.fit(tracker=...)` with a strict MemorySink; the loss is NaN at
    GUARD_SKIPS. Each skipped step must write nothing (w, mu and nu equal
    their copies from before it, bit for bit) while adamw_epilogue still
    launches once (it returns at keep 0); nonfinite_count is the gradient's
    element count there, the guard's ladder reaches rung 1, the carried
    ascent norm stays finite. Returns the counts and the guard's cost: the
    median clean guarded step against the train phase's unguarded one."""
    import statistics
    import torch
    from repro_torch.engine import Callback, Engine, GuardConfig, GuardedExecutor, ThroughputMeter
    from repro_torch.kernels import fused_update as fu
    from repro_torch.launch.train import kernel_launches
    from repro_torch.obs import MemorySink, Tracker
    from repro_torch.optim.base import AdamState

    t_phase = time.perf_counter()
    poison = {"on": False}

    def wrap(loss_fn):
        def loss(params, batch, gen):
            value, aux = loss_fn(params, batch, gen)
            return (value * float("nan") if poison["on"] else value), aux
        return loss

    cfg, ex, state, pipe = build_trainer(GUARD_STEPS, LR, mkw={"guard_update": True},
                                         loss_wrap=wrap)
    guard = GuardedExecutor(ex, GuardConfig())
    n_params = sum(b.numel() for b in state.params.buffers)

    def buffers(st):
        adam = next(x for x in st.opt_state if isinstance(x, AdamState))
        return {"w": st.params.buffers, "mu": adam.mu.buffers, "nu": adam.nu.buffers}

    rows, snap = [], {}
    launched = {"before": 0}

    class Watch(Callback):
        def on_step(self, engine, st, metrics, step_time_s):
            i = st.step - 1                              # the step just taken
            n_epi = fu.launches["adamw_epilogue"] - launched["before"]
            launched["before"] = fu.launches["adamw_epilogue"]
            row = {k: float(metrics[k]) for k in ("loss", "update_skipped", "nonfinite_count",
                                                  "guard_state", "rho_scale", "perturbed")}
            row.update(step=i, adamw_epilogue=n_epi, step_s=step_time_s,
                       carried_norm=float(st.method_state.ascent_norm))
            if i in GUARD_SKIPS:
                row["unchanged"] = all(unchanged(a, b) for k, bufs in buffers(st).items()
                                       for a, b in zip(bufs, snap[k]))
            rows.append(row)
            # the copies' blocks go back to the allocator's cache, which the
            # next step reuses (emptying it would time cudaMalloc into the step)
            snap.clear()
            poison["on"] = st.step in GUARD_SKIPS       # the next step's loss
            if poison["on"]:
                snap.update({k: [b.clone() for b in bufs] for k, bufs in buffers(st).items()})

    sink = MemorySink(strict=True)
    meter = ThroughputMeter(tokens_per_batch=TRAIN_BATCH * TRAIN_SEQ)
    reset_launches()                                     # counts: 0 just before
    torch.cuda.reset_peak_memory_stats()
    report = Engine(guard, pipe, [meter, Watch()]).fit(state, GUARD_STEPS,
                                                        tracker=Tracker([sink]))
    launches = kernel_launches()                         # read just after
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for row in rows:
        print("guard step " + json.dumps(row))
    clean = [r["step_s"] for r in rows if r["step"] >= 2 and r["step"] not in GUARD_SKIPS]
    guarded_s = statistics.median(clean)
    out = dict(steps=report.steps_done, params=n_params, launches=launches,
               skipped=[r["step"] for r in rows if r["update_skipped"] == 1.0],
               guard_states=[r["guard_state"] for r in rows], steps_skipped=guard.steps_skipped,
               logged_steps=len(sink.steps), median_clean_guarded_step_s=guarded_s,
               median_unguarded_step_s=unguarded_step_s,
               guard_cost_s=guarded_s - unguarded_step_s, peak_gib=peak_gib,
               loss_last=rows[-1]["loss"], phase_s=time.perf_counter() - t_phase)
    print(f"guard: median clean guarded step {guarded_s:.4f} s (steps "
          f"{[r['step'] for r in rows if r['step'] >= 2 and r['step'] not in GUARD_SKIPS]}) "
          f"against the train phase's unguarded {unguarded_step_s:.4f} s: "
          f"{guarded_s - unguarded_step_s:+.4f} s a step; peak {peak_gib:.2f} GiB")
    flash_n, _ = flash_per_step(cfg)
    problems = []
    if out["skipped"] != list(GUARD_SKIPS):
        problems.append(f"update_skipped at {out['skipped']}, expected {list(GUARD_SKIPS)}")
    for r in rows:
        skip = r["step"] in GUARD_SKIPS
        if skip and not r["unchanged"]:
            problems.append(f"step {r['step']}: w/mu/nu changed on a skipped step")
        if r["adamw_epilogue"] != 1:
            problems.append(f"step {r['step']}: adamw_epilogue launched {r['adamw_epilogue']}")
        if r["nonfinite_count"] != (n_params if skip else 0):
            problems.append(f"step {r['step']}: nonfinite_count {r['nonfinite_count']}")
        if not math.isfinite(r["carried_norm"]):
            problems.append(f"step {r['step']}: carried ascent norm {r['carried_norm']}")
    if max(out["guard_states"]) < 1:
        problems.append(f"guard_state never reached 1: {out['guard_states']}")
    if not math.isfinite(out["loss_last"]) or out["logged_steps"] != GUARD_STEPS:
        problems.append(f"final loss {out['loss_last']}, {out['logged_steps']} logged steps")
    want = {k: (GUARD_STEPS if k in PATH_KERNELS["adamw"] else
                flash_n * GUARD_STEPS if k == "flash_attention" else 0) for k in launches}
    if launches != want:
        problems.append(f"launches {launches}, expected {want}")
    if problems:
        fail(f"guard phase: {problems}")
    del ex, guard, state, pipe, report, snap
    torch.cuda.empty_cache()
    return out


def coarsen_(t, bits: int) -> None:
    """Round every element of the fp32 tensor t in place to `bits`
    significant bits (bf16 keeps 8)."""
    import torch
    drop = 24 - bits
    iv = t.view(torch.int32)
    iv.copy_((iv + (1 << (drop - 1))) & ~((1 << drop) - 1))


def check_run(lr: float, plain=False, w0=None, to_host: bool = False, coarse_bits: int = 0,
              **trainer):
    """3 steps from the seed-0 init (olmo-1b unless `trainer` names another
    cfg, batch or seq for `build_trainer`; with `coarse_bits` its weights
    rounded to that many significant bits), every entry point forced to its
    plain version when `plain`. Returns (metrics history, final {w, mu, nu}
    buffers, the init w on the host); the buffers stay on the card unless
    `to_host` (the plain path's temporaries need the room), and the
    executor's workspace is freed."""
    import gc
    import torch
    from repro_torch.engine import Engine
    from repro_torch.kernels import ops

    if plain:
        ops.set_default_impl("plain")
    try:
        cfg, ex, state, pipe = build_trainer(TRAIN_CHECK_STEPS, lr, **trainer)
        if w0 is None:
            w0 = state.params.buffers[0].cpu()
        if coarse_bits:
            for buf in state.params.buffers:
                coarsen_(buf, coarse_bits)
        report = Engine(ex, pipe).fit(state, TRAIN_CHECK_STEPS)
    finally:
        ops.set_default_impl(None)
    final = report.final_state
    adam = final.opt_state[0]                          # (AdamState, (), lr state)
    bufs = {"w": final.params.buffers[0], "mu": adam.mu.buffers[0], "nu": adam.nu.buffers[0]}
    if to_host:
        bufs = {k: v.cpu() for k, v in bufs.items()}
    hist = report.metrics_history
    del ex, state, pipe, report, final, adam
    gc.collect()
    torch.cuda.empty_cache()
    return hist, bufs, w0


def compare_runs(ref_run, run, w0) -> dict:
    """Per-step scalar differences and, per buffer, max|d|, max|change| and
    their ratio, and the BULK_QUANTILES of |d| and of |change| (over every
    BULK_STRIDE-th element); change is the reference run's own move from the
    init, for mu and nu their value. Buffers may lie on the host."""
    import torch
    (hist_r, bufs_r), (hist, bufs) = ref_run, run
    out = {"steps": []}
    for mr, m in zip(hist_r, hist):
        row = {k: abs(m[k] - mr[k]) / max(abs(mr[k]), 1e-30)
               for k in ("loss", "ascent_norm", "grad_norm") if mr[k] != 0.0}
        row["ascent_cosine_abs"] = abs(m["ascent_cosine"] - mr["ascent_cosine"])
        out["steps"].append(row)
    q = torch.tensor(BULK_QUANTILES, device="cuda")
    for name in ("w", "mu", "nu"):
        err = change = 0.0
        d_s, c_s = [], []
        for i in range(0, bufs[name].numel(), COMPARE_CHUNK):
            r = bufs_r[name][i:i + COMPARE_CHUNK].cuda()
            d = (bufs[name][i:i + COMPARE_CHUNK].cuda() - r).abs()
            c = (r - w0[i:i + COMPARE_CHUNK].cuda()).abs() if name == "w" else r.abs()
            err, change = max(err, float(d.max())), max(change, float(c.max()))
            d_s.append(d[(-i) % BULK_STRIDE::BULK_STRIDE])
            c_s.append(c[(-i) % BULK_STRIDE::BULK_STRIDE])
        out[name] = {"max_abs": err, "max_change": change, "max_rel": err / change,
                     "q_abs": torch.quantile(torch.cat(d_s), q).tolist(),
                     "q_change": torch.quantile(torch.cat(c_s), q).tolist()}
    return out


def lockstep_check(family: str = "adamw", names=None, steps: int = TRAIN_CHECK_STEPS,
                   **trainer) -> dict:
    """`steps` steps at the train phase's lr through the kernels (olmo-1b's
    AsyncSAM unless `trainer` names another cfg, method or its fields for
    `build_trainer`), each call of the weight-space kernels `names` (the
    family's epilogue kernels by default) held against its plain version on
    the same inputs (see LOCKSTEP_REL_TOL). Returns {kernel: {calls,
    launches, max_rel_err}}."""
    import torch
    from repro_torch.engine import Engine
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.train import kernel_launches

    names = names or PATH_KERNELS[family]
    kernel = {name: getattr(ops, name) for name in names}
    worst = {name: {"calls": 0, "max_rel_err": 0.0} for name in names}

    def note(name, pairs):
        """pairs: (max|d|, scale) per quantity of one call."""
        worst[name]["calls"] += 1
        for err, scale in pairs:
            worst[name]["max_rel_err"] = max(worst[name]["max_rel_err"],
                                             err / max(scale, 1e-30))

    def chunked(n, fn):
        """max over COMPARE_CHUNK slices of fn(slice) -> [(err, scale)...]."""
        best = None
        for i in range(0, n, COMPARE_CHUNK):
            cur = fn(slice(i, i + COMPARE_CHUNK))
            best = cur if best is None else [(max(e, be), max(s, bs))
                                             for (e, s), (be, bs) in zip(cur, best)]
        return best

    def amax(t) -> float:
        return float(t.float().abs().max())

    def sq_norm(g, **kw):
        got = kernel["sq_norm"](g, **kw)
        want = ref.sq_norm_plain(g)
        note("sq_norm", [(abs(float(got) - float(want)), abs(float(want)))])
        return got

    def fused_axpy(alpha, x, y, **kw):
        got = kernel["fused_axpy"](alpha, x, y, **kw)

        def part(sl):
            want = ref.axpy_flat_plain(alpha, x[sl], y[sl])
            return [(amax(got[sl].float() - want.float()), amax(want.float() - y[sl].float()))]
        note("fused_axpy", chunked(y.numel(), part))
        return got

    def sam_perturb(w, g, rho, sq, **kw):
        got = kernel["sam_perturb"](w, g, rho, sq, **kw)

        def part(sl):
            want = ref.sam_perturb_flat_plain(w[sl], g[sl], rho, sq)
            return [(amax(got[sl].float() - want.float()), amax(want.float() - w[sl].float()))]
        note("sam_perturb", chunked(w.numel(), part))
        return got

    def fused_dot_norms(a, b, **kw):
        got = kernel["fused_dot_norms"](a, b, **kw)
        want = ref.dot_norms_flat_plain(a, b)
        note("fused_dot_norms", [(abs(float(g_) - float(w_)), abs(float(w_)))
                                 for g_, w_ in zip(got, want)])
        return got

    def adamw_epilogue(w, g, mu, nu, clip_scale, lr, c1, c2, **kw):
        w0_, mu0, nu0 = w.clone(), mu.clone(), nu.clone()
        got = kernel["adamw_epilogue"](w, g, mu, nu, clip_scale, lr, c1, c2, **kw)
        hyper = {k: v for k, v in kw.items() if k != "impl"}

        def part(sl):
            nw, nmu, nnu = ref.adamw_epilogue_flat_plain(w0_[sl], g[sl], mu0[sl], nu0[sl],
                                                         clip_scale, lr, c1, c2, **hyper)
            return [(amax(w[sl].float() - nw.float()), amax(nw.float() - w0_[sl].float())),
                    (amax(mu[sl] - nmu), amax(nmu)), (amax(nu[sl] - nnu), amax(nnu))]
        note("adamw_epilogue", chunked(w.numel(), part))
        del w0_, mu0, nu0
        return got

    def sgd_epilogue(w, g, m, clip_scale, lr, **kw):
        w0_, m0 = w.clone(), (m.clone() if m is not None else None)
        got = kernel["sgd_epilogue"](w, g, m, clip_scale, lr, **kw)
        hyper = {k: v for k, v in kw.items() if k != "impl"}

        def part(sl):
            nw, nm = ref.sgd_epilogue_flat_plain(w0_[sl], g[sl], None if m0 is None else m0[sl],
                                                 clip_scale, lr, **hyper)
            out = [(amax(w[sl].float() - nw.float()), amax(nw.float() - w0_[sl].float()))]
            return out + ([(amax(m[sl] - nm), amax(nm))] if nm is not None else [])
        note("sgd_epilogue", chunked(w.numel(), part))
        del w0_, m0
        return got

    shadows = dict(sq_norm=sq_norm, sam_perturb=sam_perturb, fused_axpy=fused_axpy,
                   fused_dot_norms=fused_dot_norms, adamw_epilogue=adamw_epilogue,
                   sgd_epilogue=sgd_epilogue)
    cfg, ex, state, pipe = build_trainer(steps, LR if family == "adamw" else SGD_LR, family,
                                         **trainer)
    before = kernel_launches()
    for name in names:
        setattr(ops, name, shadows[name])
    try:
        Engine(ex, pipe).fit(state, steps)
    finally:
        for name, fn in kernel.items():
            setattr(ops, name, fn)
    after = kernel_launches()
    del ex, state, pipe
    torch.cuda.empty_cache()
    for name in names:
        worst[name]["launches"] = after[name] - before[name]
    return worst


def sgd_check() -> dict:
    """The SGD path's lockstep check: sgd_epilogue, elementwise, is held to
    its plain version exactly (0 error), the others as in train_check."""
    lock = lockstep_check("sgd")
    ok = all(r["calls"] == r["launches"] == TRAIN_CHECK_STEPS
             and r["max_rel_err"] <= (0.0 if name == "sgd_epilogue" else LOCKSTEP_REL_TOL)
             for name, r in lock.items())
    print(f"train sgd check, lockstep ({TRAIN_CHECK_STEPS} steps, lr {SGD_LR}, momentum "
          f"{SGD_MOMENTUM}; each epilogue kernel call on the path vs its plain version on the "
          f"same inputs): {json.dumps(lock)}; tolerance: sgd_epilogue 0 (w against the step's "
          f"own change, m against max|m|), the others rel {LOCKSTEP_REL_TOL}; one call and one "
          f"launch per step each")
    if not ok:
        fail("an epilogue kernel on the SGD training path disagrees with its plain version")
    return lock


def train_check() -> dict:
    """The lockstep check and the whole-path check (see LOCKSTEP_REL_TOL and
    WHOLE_CHECK_LR for what each holds and why)."""
    lock = lockstep_check()
    ok_lock = all(r["calls"] == r["launches"] == TRAIN_CHECK_STEPS
                  and r["max_rel_err"] <= LOCKSTEP_REL_TOL for r in lock.values())
    print(f"train check, lockstep ({TRAIN_CHECK_STEPS} steps, lr {LR}; each epilogue kernel "
          f"call on the path vs its plain version on the same inputs): {json.dumps(lock)}; "
          f"tolerance: rel {LOCKSTEP_REL_TOL}, one call and one launch per step each")

    kern_hist, kern_bufs, w0 = check_run(WHOLE_CHECK_LR, to_host=True)
    hist, bufs, _ = check_run(WHOLE_CHECK_LR, True, w0)
    whole = compare_runs((hist, bufs), (kern_hist, kern_bufs), w0)
    del kern_bufs, bufs, w0
    ok_whole = all(v <= (COSINE_ABS_TOL if k == "ascent_cosine_abs" else SCALAR_REL_TOL)
                   for row in whole["steps"] for k, v in row.items())
    ok_whole &= all(whole[k]["max_rel"] <= MOMENT_REL_TOL[k] for k in ("mu", "nu"))
    w_bulk = whole["w"]["q_abs"][0] / whole["w"]["q_change"][0]
    ok_whole &= w_bulk <= W_BULK_TOL
    print(f"train check, whole kernel path vs plain path ({TRAIN_CHECK_STEPS} steps, lr "
          f"{WHOLE_CHECK_LR}; quantiles {list(BULK_QUANTILES)}): {json.dumps(whole)}; w bulk: "
          f"median|d| / median|change| = {w_bulk:.3e}; tolerances: loss/ascent_norm/"
          f"grad_norm rel {SCALAR_REL_TOL}, ascent_cosine abs {COSINE_ABS_TOL}, mu rel "
          f"{MOMENT_REL_TOL['mu']}, nu rel {MOMENT_REL_TOL['nu']}, w bulk {W_BULK_TOL}")
    if not ok_lock:
        fail("an epilogue kernel on the training path disagrees with its plain version")
    if not ok_whole:
        fail("training on the kernel path disagrees with the plain path")
    return {"lockstep": lock, "whole": whole, "w_bulk": w_bulk}


# Restart phase: full width, depth cut to 2 layers (about 237 M parameters,
# 0.95 GB a fp32 buffer) for the checkpoints' disk and time.
RESTART_LAYERS, RESTART_STEPS, RESTART_SAVE_EVERY, RESTART_FAIL_AT = 2, 6, 3, 4
SAM_STEPS = 2


def restart_phase() -> dict:
    """SGD-momentum AsyncSAM under Engine.fit with a CheckpointCallback and a
    failure injected before step RESTART_FAIL_AT, against the same run
    uninterrupted: one restart, the final params, momentum and carried ascent
    gradient equal bit for bit, the live buffers kept through the restore.
    Then the SAM path, whose perturbation runs sq_norm + sam_perturb."""
    import dataclasses as dc
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.engine import CheckpointCallback, Engine
    from repro_torch.launch.train import kernel_launches
    from repro_torch.runtime import InjectedFailure, ResilienceConfig

    cfg = dc.replace(get_config("olmo-1b"), n_layers=RESTART_LAYERS)

    class TimedManager(CheckpointManager):
        """Times every save() call (its blocking part: the copy to host, and
        the write too for a blocking save), wait() and restore()."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.times = {"save": [], "wait": [], "restore": []}

        def _timed(self, what, fn, *args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.times[what].append(round(time.perf_counter() - t0, 4))

        def save(self, step, state, extras=None, blocking=True):
            return self._timed("save", super().save, step, state, extras, blocking)

        def wait(self):
            return self._timed("wait", super().wait)

        def restore(self, *args, **kw):
            return self._timed("restore", super().restore, *args, **kw)

    def buffers(state):
        return {"params": state.params.buffers[0],
                "momentum": state.opt_state[0].momentum.buffers[0],
                "ascent_grad": state.method_state.ascent_grad.buffers[0]}

    _, ex, state, pipe = build_trainer(RESTART_STEPS, SGD_LR, "sgd", cfg)
    n_params = state.params.buffers[0].numel()
    clean = buffers(Engine(ex, pipe).fit(state, RESTART_STEPS).final_state)
    del ex, state, pipe

    _, ex, state, pipe = build_trainer(RESTART_STEPS, SGD_LR, "sgd", cfg)
    live = {k: v for k, v in buffers(state).items() if k != "ascent_grad"}
    fired = []

    def inject(step):
        if step == RESTART_FAIL_AT and not fired:
            fired.append(step)
            raise InjectedFailure(f"injected node loss before step {step}")

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        mgr = TimedManager(tmp, keep=3)
        t0 = time.perf_counter()
        rep = Engine(ex, pipe, [CheckpointCallback(
            mgr, ResilienceConfig(save_every=RESTART_SAVE_EVERY))]).fit(
                state, RESTART_STEPS, failure_injector=inject)
        wall_s = time.perf_counter() - t0
        kept = sorted(p.name for p in tmp.glob("step_*"))
        ckpt_bytes = sum(f.stat().st_size for f in (tmp / kept[-1]).rglob("*") if f.is_file())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got = buffers(rep.final_state)
    equal = {k: bool(torch.equal(got[k], clean[k])) for k in clean}
    in_place = all(got[k] is live[k] for k in live)
    hist = rep.metrics_history
    out = dict(layers=RESTART_LAYERS, params=n_params, steps=rep.steps_done,
               restarts=rep.restarts, bitwise_equal=equal, buffers_kept=in_place,
               checkpoints_kept=kept, bytes_per_checkpoint=ckpt_bytes, wall_s=wall_s,
               save_s=mgr.times["save"], wait_s=mgr.times["wait"],
               restore_s=mgr.times["restore"])
    print(f"restart: olmo-1b at full width, {RESTART_LAYERS} layers ({n_params} params), "
          f"{RESTART_STEPS} SGD-momentum AsyncSAM steps, save every {RESTART_SAVE_EVERY} "
          f"(asynchronous), failure before step {RESTART_FAIL_AT}: {json.dumps(out)}")
    if not (rep.restarts == 1 and rep.steps_done == RESTART_STEPS and all(equal.values())
            and in_place and all(math.isfinite(v) for m in hist for v in m.values())):
        fail("the restarted run is not the uninterrupted run bit for bit, in place")
    del ex, state, pipe, rep, got, clean, live
    torch.cuda.empty_cache()

    # the SAM path: sq_norm gives the ascent norm, sam_perturb the perturbation
    _, ex, state, pipe = build_trainer(SAM_STEPS, SGD_LR, "sgd", cfg, method="sam")
    reset_launches()                                   # counts: 0 just before
    rep = Engine(ex, pipe).fit(state, SAM_STEPS)
    launches = kernel_launches()                       # read just after
    flash_n, _ = flash_per_step(cfg)
    want = {"flash_attention": flash_n * SAM_STEPS, "sq_norm": 2 * SAM_STEPS,
            "sam_perturb": SAM_STEPS, "sgd_epilogue": SAM_STEPS}
    print(f"sam path ({SAM_STEPS} steps, {RESTART_LAYERS} layers): launches {launches}; "
          f"losses {[m['loss'] for m in rep.metrics_history]}")
    if launches != {k: want.get(k, 0) for k in launches} or not all(
            math.isfinite(v) for m in rep.metrics_history for v in m.values()):
        fail(f"the SAM path launched {launches}, expected {want} and no other kernel, "
             f"with finite metrics")
    out["sam_launches"] = launches
    del ex, state, pipe, rep
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# delta kernel phase
# ---------------------------------------------------------------------------

# p in the case's dtype, the shadow s and the residual e in fp32
DELTA_CASES = EPILOGUE_CASES + [("bf16 p, unaligned", 3 * 65536 + 17, "bfloat16", 1)]
# ops per element: amax sub, add, abs, max; encode sub, add, div, rint, two
# compares, the NaN test, the cast, mul, add, sub
DELTA_OPS = {"delta_amax": 4, "delta_encode_i8": 11}


def chunks(n: int):
    return [slice(i, i + COMPARE_CHUNK) for i in range(0, n, COMPARE_CHUNK)]


def same(got, want) -> tuple[bool, float]:
    """(bit for bit equal, NaN where NaN; max|got - want| elsewhere)."""
    import torch
    g, w = got.float(), want.float()
    nan = torch.isnan(g) | torch.isnan(w)
    eq = bool(torch.equal(torch.isnan(g), torch.isnan(w))) and bool(
        torch.equal(got[~nan], want[~nan]))
    d = (g - w).abs()[~nan & torch.isfinite(w)]
    return eq, float(d.max()) if d.numel() else 0.0


def plain_amax(p, s, e):
    import torch
    from repro_torch.kernels import ref
    return torch.stack([ref.delta_amax_flat_plain(p[sl], s[sl], e[sl])
                        for sl in chunks(p.numel())]).amax()


def delta_phase() -> dict:
    """delta_amax and delta_encode_i8 against their plain versions on the
    card, exactly (amax, q, s', e'); returns the olmo-1b bucket's rows."""
    import torch
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import ref
    from repro_torch.service.delta import _pow2_scale

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows, failures = {}, []

    def operand(n, dtype, offset, scale):
        t = torch.empty(n + offset, dtype=torch.float32, device="cuda")
        return t.normal_(0.0, scale, generator=gen).to(getattr(torch, dtype))[offset:]

    def run(case, p, s, e, main, timed=True):
        n, es = p.numel(), p.element_size()
        amax = fu.delta_amax(p, s, e)
        ok_a, err_a = same(amax, plain_amax(p, s, e))
        scale = float(_pow2_scale(float(amax)))
        s0, e0 = s.clone(), e.clone()
        q, _, _ = fu.delta_encode_i8(p, s, e, scale)
        torch.cuda.synchronize()
        ok_q, err_q = True, 0.0
        for sl in chunks(n):
            for got, want in zip((q[sl], s[sl], e[sl]),
                                 ref.delta_encode_i8_flat_plain(p[sl], s0[sl], e0[sl], scale)):
                ok, err = same(got, want)
                ok_q, err_q = ok_q and ok, max(err_q, err)
        del s0, e0, q
        out = {}
        for kernel, ok, err, nbytes in (("delta_amax", ok_a, err_a, n * (es + 8)),
                                        ("delta_encode_i8", ok_q, err_q, n * (es + 17))):
            if timed and kernel == "delta_amax":
                ms = time_ms(lambda: fu.delta_amax(p, s, e))
                plain_ms = time_ms(lambda: ref.delta_amax_flat_plain(p, s, e))
            elif timed:
                ms = time_ms(lambda: fu.delta_encode_i8(p, s, e, scale))
                plain_ms = time_ms(lambda: ref.delta_encode_i8_flat_plain(p, s, e, scale))
            else:
                ms = plain_ms = None
            bound_ms, bound_by = bound(nbytes, DELTA_OPS[kernel] * n)
            row = dict(kernel=kernel, case=case, n=n, dtype=str(p.dtype).removeprefix("torch."),
                       amax=float(amax), scale=scale, exact=ok, max_abs_err=err, ms=ms,
                       plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
            print("delta " + json.dumps(row))
            if not ok:
                failures.append(f"{kernel} / {case}")
            if main:
                rows[kernel] = row
            out[kernel] = row
        torch.cuda.empty_cache()
        return out

    for ci, (case, n, dtype, offset) in enumerate(DELTA_CASES):
        p = operand(n, dtype, offset, 2e-2)
        s = operand(n, "float32", offset, 1e-3)
        s.add_(p)                                      # the shadow: near p
        e = operand(n, "float32", offset, 1e-4)
        run(case, p, s, e, ci == 0)
        del p, s, e
    for bad in (float("nan"), float("inf")):
        n = 3 * 65536 + 17
        p = operand(n, "float32", 0, 2e-2)
        p[[5, 70000, n - 3]] = bad
        s = operand(n, "float32", 0, 1e-3)
        e = operand(n, "float32", 0, 1e-4)
        got = run(f"{bad} in p", p, s, e, False, timed=False)
        if (got["delta_amax"]["amax"] == got["delta_amax"]["amax"]) == (bad != bad):
            failures.append(f"delta_amax / {bad} in p: amax {got['delta_amax']['amax']}")
    if failures:
        fail(f"delta kernels disagree with their plain versions: {failures}")
    return rows


# ---------------------------------------------------------------------------
# remote phase: Form B across processes (the slice's main path)
# ---------------------------------------------------------------------------

REMOTE_LAYERS, REMOTE_STEPS = 6, 4
REMOTE_LOSS_SPEC = "chip_smoke:olmo6_loss"
_OLMO6: list = []


def olmo6_loss(params, batch, gen=None):
    """The loss of olmo-1b at full width and REMOTE_LAYERS layers: what the
    remote phase's ascent server holds (`--loss chip_smoke:olmo6_loss`; the
    loss specs have no depth override)."""
    if not _OLMO6:
        from repro_torch.configs import get_config
        from repro_torch.models import build_model
        _OLMO6.append(build_model(dataclasses.replace(get_config("olmo-1b"),
                                                      n_layers=REMOTE_LAYERS)))
    return _OLMO6[0].loss_fn(params, batch, gen)


def host_mem_available_gib() -> float:
    """MemAvailable of /proc/meminfo, GiB (the host's, both processes')."""
    for line in pathlib.Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return round(int(line.split()[1]) / 2**20, 2)
    return float("nan")


def remote_phase() -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import MethodConfig
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.engine import Callback, Engine, RemoteExecutor, ThroughputMeter
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.train import kernel_launches
    from repro_torch.models import build_model
    from repro_torch.obs import MemorySink, Tracker
    from repro_torch.optim import cosine_schedule, sgd
    from repro_torch.runtime import ExecutorConfig
    from repro_torch.service import protocol
    from repro_torch.service.delta import ShadowState

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("olmo-1b"), n_layers=REMOTE_LAYERS)
    bundle = build_model(cfg)
    ex = RemoteExecutor(
        bundle.loss_fn, MethodConfig(name="async_sam", rho=RHO, ascent_fraction=ASCENT_FRACTION),
        sgd(cosine_schedule(SGD_LR, REMOTE_STEPS), momentum=SGD_MOMENTUM),
        exec_cfg=ExecutorConfig(lockstep=True, serve_ascent=True, loss_spec=REMOTE_LOSS_SPEC,
                                descent_device="cuda", job_compress="int8", lane_ladder=True))
    print(f"remote: ascent server spawned at {ex.server.addr} (on the card, pid "
          f"{ex.server.proc.pid}) in {time.perf_counter() - t_phase:.2f}s")
    state = ex.init_state(bundle.init(seed=0, device="cuda"), seed=1)
    n_params = sum(b.numel() for b in state.params.buffers)
    n_buckets = len(state.params.buffers)
    pipe = TokenPipeline(cfg, PipelineConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                             seed=0, ascent_fraction=ASCENT_FRACTION),
                         device="cuda")
    enc = ex.client.job_encoder

    # every job the encoder makes, for the replay; every delta kernel call
    # held to its plain version on its inputs (the lockstep check)
    jobs = []
    encode = enc.encode

    def recording_encode(*args, **kw):
        job = encode(*args, **kw)
        jobs.append((job, enc.last_d2h_s if job.kind != "snapshot" else None))
        return job

    enc.encode = recording_encode
    kernel = {"delta_amax": ops.delta_amax, "delta_encode_i8": ops.delta_encode_i8}
    check = {k: {"calls": 0, "exact": True, "max_abs_err": 0.0} for k in kernel}

    def note(name, ok, err):
        check[name]["calls"] += 1
        check[name]["exact"] &= ok
        check[name]["max_abs_err"] = max(check[name]["max_abs_err"], err)

    def delta_amax(p, s, e, **kw):
        got = kernel["delta_amax"](p, s, e, **kw)
        note("delta_amax", *same(got, plain_amax(p, s, e)))
        return got

    def delta_encode_i8(p, s, e, scale, **kw):
        s0, e0 = s.clone(), e.clone()
        got = kernel["delta_encode_i8"](p, s, e, scale, **kw)
        ok, err = True, 0.0
        for sl in chunks(p.numel()):
            for g_, w_ in zip((got[0][sl], s[sl], e[sl]),
                              ref.delta_encode_i8_flat_plain(p[sl], s0[sl], e0[sl], scale)):
                o, d = same(g_, w_)
                ok, err = ok and o, max(err, d)
        note("delta_encode_i8", ok, err)
        del s0, e0
        return got

    meter = ThroughputMeter(tokens_per_batch=TRAIN_BATCH * TRAIN_SEQ)
    mem_avail = []

    class HostMemory(Callback):
        def on_step(self, engine, state, metrics, step_time_s):
            mem_avail.append(host_mem_available_gib())

    ops.delta_amax, ops.delta_encode_i8 = delta_amax, delta_encode_i8
    reset_launches()                                   # counts: 0 just before
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sink = MemorySink(strict=True)
    try:
        report = Engine(ex, pipe, [meter, HostMemory()]).fit(state, REMOTE_STEPS,
                                                              tracker=Tracker([sink]))
    finally:
        ops.delta_amax, ops.delta_encode_i8 = kernel["delta_amax"], kernel["delta_encode_i8"]
    launches = kernel_launches("remote")               # read just after
    fit_s = time.perf_counter() - t0
    client_peak = torch.cuda.max_memory_allocated()
    hist = report.metrics_history
    descent_s = list(ex.timings["descent"])
    by_step = {job.step: (job.kind, d2h) for job, d2h in jobs}
    for i, m in enumerate(hist):
        kind, d2h = by_step.get(i, (None, None))
        print(f"remote step {i}: loss {m['loss']:.6f} tau {m['tau']} perturbed "
              f"{m['perturbed']}; harvested exchange: job_bytes {m.get('job_bytes')} "
              f"grad_bytes {m.get('grad_bytes')} rtt_s {m.get('rtt_s')}; this step's job: "
              f"{kind}, q to host {d2h} s; descent {descent_s[i]:.4f} s; step "
              f"{meter.step_times[i]:.4f} s; host memory available {mem_avail[i]} GiB")
    kinds = [j.kind for j, _ in jobs]
    snap_bytes = ex.client.job_frame_measured.get("snapshot")
    int8_bytes = ex.client.job_frame_measured.get("int8")

    # the replay: the snapshot and every int8 payload through ShadowState's
    # numpy arithmetic (what the server holds) against the client's shadow
    replay = ShadowState()
    for job, _ in jobs:
        if job.kind == "snapshot":
            replay.install(job.params, job.sync)
        else:
            replay.apply(job.kind, job.deltas, job.sync, job.seq)
    shadow = enc.shadow_host()
    replay_equal = len(shadow) == len(replay.bufs) and all(
        np.array_equal(a, b) for a, b in zip(replay.bufs, shadow))
    frames = {k: protocol.job_frame_bytes(k, jobs[0][0].params, jobs[0][0].batch,
                                          jobs[0][0].rng, delta=k != "none")
              for k in ("none", "int8")}
    ex.close()                                         # kills the server: its exit lines
    tail = list(ex.server.tail)
    print("remote: the ascent server's last lines:\n  " + "\n  ".join(tail[-20:]))
    print(f"remote: client drops {ex.client.drops}, retried {ex.client.retried_exchanges}, "
          f"reconnects {ex.client.reconnects}, server respawns {ex.server_respawns}, last "
          f"error {ex.client.last_error!r}")
    server_peak = next((ln for ln in tail if ln.startswith("ascent-server peak")), None)
    pool_stats = ex.server.stats()
    out = dict(layers=REMOTE_LAYERS, params=n_params, buckets=n_buckets, steps=report.steps_done,
               taus=[m["tau"] for m in hist], perturbed=[m["perturbed"] for m in hist],
               losses=[m["loss"] for m in hist], job_kinds=kinds,
               snapshot_jobs=enc.snapshot_jobs, delta_jobs=enc.delta_jobs,
               encode_failures=enc.encode_failures, launches=launches, lockstep=check,
               shadow_equals_replay=replay_equal, job_bytes_snapshot=snap_bytes,
               job_bytes_int8=int8_bytes, job_bytes_model=frames,
               job_ratio=(snap_bytes / int8_bytes) if snap_bytes and int8_bytes else None,
               grad_bytes=[m.get("grad_bytes") for m in hist[1:]],
               rtt_s=[m.get("rtt_s") for m in hist[1:]],
               q_d2h_s=[d for _, d in jobs if d is not None], descent_s=descent_s,
               step_s=meter.step_times, fit_s=fit_s, client_peak_bytes=client_peak,
               server_peak=server_peak, pool_stats=pool_stats,
               lane_states=[m.get("lane_state") for m in hist],
               ascent_rpc_spans=sum(sp.name == "ascent_rpc" for sp in sink.spans),
               ascent_exchange_spans=sum(sp.name == "ascent_exchange" for sp in sink.spans),
               phase_s=time.perf_counter() - t_phase)
    print("remote " + json.dumps(out))
    flash_n = (1 if cfg.remat == "none" else 2) * cfg.n_layers     # one gradient pass a step
    want = {"flash_attention": flash_n * REMOTE_STEPS, "sq_norm": REMOTE_STEPS,
            "fused_axpy": REMOTE_STEPS, "sgd_epilogue": REMOTE_STEPS,
            "delta_amax": enc.delta_jobs * n_buckets,
            "delta_encode_i8": enc.delta_jobs * n_buckets}
    problems = []
    if out["taus"] != [0.0] + [1.0] * (REMOTE_STEPS - 1) or out["perturbed"] != out["taus"]:
        problems.append(f"taus {out['taus']} perturbed {out['perturbed']}")
    if not all(math.isfinite(v) for v in out["losses"]):
        problems.append(f"losses {out['losses']}")
    if (enc.snapshot_jobs, enc.delta_jobs, enc.encode_failures) != (1, REMOTE_STEPS - 1, 0):
        problems.append(f"jobs: {enc.snapshot_jobs} snapshot, {enc.delta_jobs} delta, "
                        f"{enc.encode_failures} encode failures")
    if launches != {k: want.get(k, 0) for k in launches}:
        problems.append(f"launches {launches}, expected {want}")
    if not all(c["calls"] == enc.delta_jobs * n_buckets and c["exact"] for c in check.values()):
        problems.append(f"lockstep {check}")
    if not replay_equal:
        problems.append("the client's shadow is not the numpy replay bit for bit")
    if snap_bytes != frames["none"] or int8_bytes != frames["int8"]:
        problems.append(f"JOB frames {snap_bytes}/{int8_bytes} != the length model {frames}")
    if out["lane_states"] != [0.0] * REMOTE_STEPS:
        problems.append(f"lane_state {out['lane_states']}, expected 0 on every step")
    if out["ascent_rpc_spans"] < REMOTE_STEPS - 1:
        problems.append(f"{out['ascent_rpc_spans']} ascent_rpc spans")
    if problems:
        fail(f"remote phase: {problems}")
    del ex, state, pipe, report, jobs, replay, shadow
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# hetero phase: the descent on the card, the ascent lane a CPU thread
# ---------------------------------------------------------------------------

# 10 steps, then more until the first fresh ascent gradient is harvested (a
# CPU ascent of one 512-token sequence takes ~8 s against a ~0.07 s descent
# step on an H100 host), at most HETERO_MAX_S seconds of stepping
HETERO_LAYERS, HETERO_SEQ, HETERO_STEPS, HETERO_MAX_S = 2, 512, 10, 60.0


def hetero_phase() -> dict:
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import MethodConfig
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.engine import HeteroExecutor
    from repro_torch.models import build_model
    from repro_torch.obs import TraceEventSink, Tracker, compute_overlap, use_tracker
    from repro_torch.optim import cosine_schedule, sgd
    from repro_torch.runtime import ExecutorConfig

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("olmo-1b"), n_layers=HETERO_LAYERS)
    bundle = build_model(cfg)
    ex = HeteroExecutor(
        bundle.loss_fn, MethodConfig(name="async_sam", rho=RHO, ascent_fraction=ASCENT_FRACTION),
        sgd(cosine_schedule(SGD_LR, 1000), momentum=SGD_MOMENTUM),
        exec_cfg=ExecutorConfig(ascent_device="cpu", descent_device="cuda"),
        calibrate=True, calibration_probes=1)
    state = ex.init_state(bundle.init(seed=0, device="cuda"), seed=1)
    pipe = TokenPipeline(cfg, PipelineConfig(global_batch=TRAIN_BATCH, seq_len=HETERO_SEQ,
                                             seed=0, ascent_fraction=ASCENT_FRACTION),
                         device="cuda")
    pre = ex.pre_fit(state, pipe.peek())
    print(f"hetero calibration (torch {torch.get_num_threads()} CPU threads): t_fast "
          f"{pre['t_fast']:.6f} s/sample (card), t_slow {pre['t_slow']:.6f} s/sample (CPU), "
          f"system-aware b'/b {pre['calibrated_ascent_fraction']:.4f} (configured "
          f"{pre['configured_ascent_fraction']})")
    hist, step_s = [], []
    it = iter(pipe)
    # the lanes' spans (ascent_compute on the CPU thread's track, descent_compute
    # on the descent's) as a Chrome trace, read back for the hidden fraction
    trace_path = ROOT / "build" / "hetero_trace.json"
    tracker = Tracker([TraceEventSink(trace_path)])
    t_run = time.perf_counter()
    try:
        with use_tracker(tracker):
            while len(hist) < HETERO_STEPS or (ex.ledger.refreshes < 1 and
                                               time.perf_counter() - t_run < HETERO_MAX_S):
                t0 = time.perf_counter()
                with tracker.span("train_step", lane="descent", step=len(hist)):
                    state, m = ex.step(state, next(it))
                step_s.append(time.perf_counter() - t0)
                hist.append({k: float(v) for k, v in m.items()
                             if k in ("loss", "tau", "perturbed")})
    finally:
        it.close()
        # the trace is written before the lane closes: the exchange still in
        # flight when the loop stops (close() waits it out, the descent
        # stopped) is not in it
        tracker.close()
        ex.close()
    overlap = compute_overlap(json.loads(trace_path.read_text()))
    print(f"hetero overlap (ascent lane on the CPU, descent on the card): hidden-perturbation "
          f"fraction {overlap['hidden_fraction']:.4f} of {overlap['ascent_busy_s']:.3f} s ascent "
          f"busy over {overlap['ascent_spans']} span(s); {json.dumps(overlap)}")
    runs = []                                   # the tau schedule as [tau, steps] runs
    for m in hist:
        if runs and runs[-1][0] == m["tau"]:
            runs[-1][1] += 1
        else:
            runs.append([m["tau"], 1])
    out = dict(layers=HETERO_LAYERS, seq=HETERO_SEQ, calibration=pre, steps=len(hist),
               tau_runs=runs, perturbed_steps=sum(m["perturbed"] for m in hist),
               ledger=ex.ledger.summary(), ascent_exchange_s=list(ex.timings["ascent"]),
               median_descent_s=statistics.median(ex.timings["descent"]),
               median_step_s=statistics.median(step_s),
               loss_first=hist[0]["loss"], loss_last=hist[-1]["loss"], overlap=overlap,
               phase_s=time.perf_counter() - t_phase)
    print("hetero " + json.dumps(out))
    if not all(math.isfinite(m["loss"]) for m in hist) or ex.ledger.refreshes < 1:
        fail(f"hetero phase: finite losses and a fresh ascent harvested needed: {out}")
    del ex, state, pipe
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# rwkv6: the wkv scan kernels, serving rwkv6-7b, training it
# ---------------------------------------------------------------------------

# (name, (B, S, H, K, V), dtype of r/k/v, init_state): the model's scan shape
# (8 x 1024 tokens, 64 heads of 64; prefill and training), a decode step
# (one token from the carried state), a ragged S, the reduced config's K = V
# = 16 in fp32. w (log decay) and u are fp32, as the model passes them.
RWKV_CASES = [
    ("rwkv6-7b scan", (8, 1024, 64, 64, 64), "bfloat16", False),
    ("decode step, S=1 from a state", (8, 1, 64, 64, 64), "bfloat16", True),
    ("ragged S=1000 from a state", (2, 1000, 64, 64, 64), "bfloat16", True),
    ("K=V=16 fp32", (8, 1024, 4, 16, 16), "float32", True),
]
# y and the state (fp32) within 1e-5 of their max, the fp32 gradients (dw,
# du, d init_state) within 1e-4 of theirs: the sums' order differs; bf16
# outputs (y, dr, dk, dv) also round once to bf16: the reference's bf16
# tolerance, relative to the output's max
RWKV_FP32_TOL, RWKV_GRAD_TOL = 1e-5, 1e-4
# fp32 ops per state element and step that the function needs. Forward: the
# y product-add and the decay multiply-add of k v (5). Backward (12), with S
# rebuilt from the initial state: S's recurrence (3), p = S dy (2), one G
# recurrence (3), G v and G^T k (2 + 2); dw comes through q at O(K) a step.
# The kernel does these 12: its one G recurrence gives both G v and G^T k.
RWKV_FWD_OPS, RWKV_BWD_OPS = 5, 12
PLAIN_GRAD_BATCH = 2                    # autograd of the plain scan, batch rows at a time


def wkv_inputs(shape, dtype: str, init: bool, seed: int = 3):
    """r, k, v in `dtype`, the log decay w = -exp(N(0, 0.5) - 2) and u in
    fp32 (the reference's kernel tests' distributions), one strongly decaying
    channel per head (exp(w) underflows to 0), init_state or None."""
    import torch
    b, s, h, dk, dv = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def n(*sh, scale=0.5):
        return torch.randn(sh, generator=g, device="cuda") * scale

    tdt = getattr(torch, dtype)
    r, k, v = n(b, s, h, dk).to(tdt), n(b, s, h, dk).to(tdt), n(b, s, h, dv).to(tdt)
    w = -torch.exp(n(b, s, h, dk) - 2.0)
    w[..., 0] = -200.0
    return r, k, v, w, n(h, dk, scale=0.1), (n(b, h, dk, dv) if init else None)


def plain_wkv_grads(r, k, v, w, u, s0, dy, ds):
    """Autograd of the plain scan, PLAIN_GRAD_BATCH batch rows at a time (its
    saved states take ~34 GB at the model's whole scan shape); du summed."""
    import torch
    from repro_torch.kernels import ref
    parts = []
    for i in range(0, r.shape[0], PLAIN_GRAD_BATCH):
        sl = slice(i, i + PLAIN_GRAD_BATCH)
        parts.append(ref.rwkv6_scan_plain_grads(
            r[sl], k[sl], v[sl], w[sl], u, None if s0 is None else s0[sl],
            None if dy is None else dy[sl], None if ds is None else ds[sl]))
    return tuple(torch.stack([p[4] for p in parts]).sum(0) if j == 4
                 else torch.cat([p[j] for p in parts]) for j in range(6))


def wkv_error(got, want) -> tuple[float, float]:
    """(max|got - want|, that over max|want|); 0 where both are 0."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1e-30) if err else 0.0


def wkv_ok(got, want, fp32_tol: float) -> bool:
    """fp32: within fp32_tol of the max; bf16: the reference's bf16
    tolerance, relative to the max."""
    import torch
    _, rel = wkv_error(got, want)
    if got.dtype == torch.float32:
        return rel <= fp32_tol
    scale = max(float(want.float().abs().max()), 1e-30)
    d = (got.float() - want.float()).abs() / scale
    return bool((d <= BF16_TOL["atol"] + BF16_TOL["rtol"] * want.float().abs() / scale).all())


def wkv_bound(shape, dtype: str, init: bool, backward: bool) -> tuple[float, str]:
    """Least time for the work: every input read once, every output written
    once, against the fp32 operations of the recurrence."""
    b, s, h, dk, dv = shape
    es = 2 if dtype == "bfloat16" else 4
    tok = b * s * h
    state = 4 * b * h * dk * dv
    inputs = tok * (2 * dk + dv) * es + tok * dk * 4 + h * dk * 4 + (state if init else 0)
    if backward:     # + dy, dS_T; out dr, dk, dv, dw, du, d init_state
        nbytes = inputs + tok * dv * es + state + tok * (2 * dk + dv) * es + tok * dk * 4 \
            + h * dk * 4 + state
        ops = RWKV_BWD_OPS * tok * dk * dv
    else:            # out y, the final state
        nbytes = inputs + tok * dv * es + state
        ops = RWKV_FWD_OPS * tok * dk * dv
    return bound(nbytes, ops)


def ptxas_report(source, kernel: str) -> dict:
    """Registers and spills of each instantiation of `kernel` in the build
    log of `source` (ptxas -v), keyed by its mangled name."""
    from repro_torch.kernels import build
    lib = build.library_path(source)
    lines = lib.with_name(lib.name + ".log").read_text().splitlines()
    out = {}
    for i, line in enumerate(lines):
        if "Compiling entry" in line and kernel in line:
            name = line.split("'")[1]
            out[name] = " ".join(part.split(":", 1)[-1].strip() for part in lines[i + 1:i + 4]
                                 if "spill" in part or "registers" in part)
    return out


def rwkv_kernel_phase() -> dict:
    """Both wkv kernels against their plain versions at RWKV_CASES, timed;
    the forward run twice (the same bits); returns the model shape's row per
    kernel."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as r6

    for name, regs in ptxas_report(r6.SOURCE, "wkv_fwd_kernel").items():
        print(f"rwkv forward ptxas {name}: {regs}")
    main_rows, failures = {}, []
    for ci, (case, shape, dtype, init) in enumerate(RWKV_CASES):
        r, k, v, w, u, s0 = wkv_inputs(shape, dtype, init)
        y, state = r6.rwkv6_scan(r, k, v, w, u, s0)
        y2, state2 = r6.rwkv6_scan(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        same_bits = bool(torch.equal(y, y2) and torch.equal(state, state2))
        del y2, state2
        y_p, state_p = ref.rwkv6_scan_plain(r, k, v, w, u, s0)
        ok = (wkv_ok(y, y_p, RWKV_FP32_TOL) and wkv_ok(state, state_p, RWKV_FP32_TOL)
              and same_bits)
        err = max(wkv_error(y, y_p)[0], wkv_error(state, state_p)[0])
        del y, state, y_p, state_p
        ms = time_ms(lambda: r6.rwkv6_scan(r, k, v, w, u, s0))
        plain_ms = time_ms(lambda: ref.rwkv6_scan_plain(r, k, v, w, u, s0), 0.0)
        bound_ms, bound_by = wkv_bound(shape, dtype, init, backward=False)
        rows = {"rwkv6_scan_fwd": dict(
            kernel="rwkv6_scan_fwd", case=case, shape=shape, dtype=dtype, init_state=init,
            max_abs_err=err, ok=ok, deterministic=same_bits, ms=ms, plain_ms=plain_ms,
            library_ms=None, bound_ms=bound_ms, bound_by=bound_by)}

        b, _, h, dk, dv = shape
        g = torch.Generator(device="cuda").manual_seed(4)
        dy = torch.randn(r.shape[:3] + (dv,), generator=g, device="cuda").to(r.dtype)
        ds = torch.randn((b, h, dk, dv), generator=g, device="cuda")
        got = r6._launch_bwd(r, k, v, w, u, s0, dy, ds)
        torch.cuda.synchronize()
        want = plain_wkv_grads(r, k, v, w, u, s0, dy, ds)
        names = ("dr", "dk", "dv", "dw", "du", "d_init_state")
        errs = {n_: wkv_error(a, e) for n_, a, e in zip(names, got, want)}
        ok_b = all(a.shape == e.shape and a.dtype == e.dtype and wkv_ok(a, e, RWKV_GRAD_TOL)
                   for a, e in zip(got, want))
        del got, want
        ms = time_ms(lambda: r6._launch_bwd(r, k, v, w, u, s0, dy, ds))
        plain_ms = time_ms(lambda: plain_wkv_grads(r, k, v, w, u, s0, dy, ds), 0.0)
        bound_ms, bound_by = wkv_bound(shape, dtype, init, backward=True)
        rows["rwkv6_scan_bwd"] = dict(
            kernel="rwkv6_scan_bwd", case=case, shape=shape, dtype=dtype, init_state=init,
            max_abs_err=max(e[0] for e in errs.values()),
            max_rel_err={n_: e[1] for n_, e in errs.items()}, ok=ok_b, ms=ms,
            plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
        for name, row in rows.items():
            print("rwkv " + json.dumps(row))
            if not row["ok"]:
                failures.append(f"{name} / {case}")
            if ci == 0:
                main_rows[name] = row
        del r, k, v, w, u, s0, dy, ds
        torch.cuda.empty_cache()
    if failures:
        fail(f"rwkv6 kernels disagree with their plain versions: {failures}")
    return main_rows


def rwkv_serve_phase():
    """Serve full-width, full-depth rwkv6-7b through the kernels and check
    the logits. Returns (summary dict, model)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenTask
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_scan as r6
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model, transformer

    t_phase = time.perf_counter()
    n_req, prompt_len, max_new = 8, 1024, 32
    cfg = get_config("rwkv6-7b")
    t0 = time.perf_counter()
    model = build_model(cfg).init(seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"rwkv6-7b init on the card: {time.perf_counter() - t0:.3f}s, "
          f"{sum(p.numel() for p in model.parameters())} params ({cfg.param_dtype}), "
          f"compute {cfg.compute_dtype}")
    prompts = TokenTask(cfg.vocab_size, seed=0).sample(n_req, prompt_len)
    serve(cfg, model, prompts, 2)                         # warm-up, not counted

    reset_launches()                                      # counts: 0 just before
    torch.cuda.reset_peak_memory_stats()
    res = serve(cfg, model, prompts, max_new)
    launches = {"rwkv6_scan_fwd": r6.launches["rwkv6_scan_fwd"],
                "rwkv6_scan_bwd": r6.launches["rwkv6_scan_bwd"]}    # read just after
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"rwkv serve: prefill {n_req}x{prompt_len} in {res.prefill_s:.4f}s "
          f"({res.prefill_tok_s:.1f} tok/s); decode {max_new - 1} steps in "
          f"{res.decode_s:.4f}s ({res.decode_tok_s:.1f} tok/s); peak {peak_gib:.2f} GiB; "
          f"launches {launches} (serve's own count {res.launches})")
    want = cfg.n_layers * max_new                         # the prefill + 31 decode steps
    if launches != {"rwkv6_scan_fwd": want, "rwkv6_scan_bwd": 0} or res.launches != {
            "rwkv6_scan_fwd": want}:
        fail(f"rwkv6 serving launched {launches}, expected {cfg.n_layers} forward launches "
             f"per prefill and per decoded token ({want}) and no backward")
    if res.tokens.shape != (n_req, max_new) or res.logits.shape != (n_req, max_new,
                                                                     cfg.vocab_size):
        fail(f"unexpected output shapes {tuple(res.tokens.shape)} {tuple(res.logits.shape)}")
    if not bool(torch.isfinite(res.logits).all()):
        fail("non-finite rwkv6 logits")

    # prefill + stepwise decode == one full forward over the same tokens
    full_tokens = torch.cat([torch.as_tensor(prompts, device="cuda").long(),
                             res.tokens[:, :-1]], dim=1)
    with torch.inference_mode():
        full, _ = transformer.forward(model, {"tokens": full_tokens}, cfg)
    err_fwd = rel_err(res.logits, full[:, prompt_len - 1:])
    del full
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
    print(f"rwkv serve check (max|d|/max|ref|): prefill+decode vs forward {err_fwd:.3e}; "
          f"kernel vs plain prefill {err_plain:.3e} (tolerance {MODEL_BF16_REL_TOL}); "
          f"fp32 compute kernel vs plain {err_fp32:.3e} (tolerance {MODEL_FP32_REL_TOL}); "
          f"bf16 error itself: bf16 plain vs fp32 plain {rel_err(plain16, plain32):.3e}")
    if not (err_fwd <= MODEL_BF16_REL_TOL and err_plain <= MODEL_BF16_REL_TOL
            and err_fp32 <= MODEL_FP32_REL_TOL):
        fail("rwkv6 serving logits disagree")
    return dict(launches=launches, prefill_s=res.prefill_s, decode_s=res.decode_s,
                prefill_tok_s=res.prefill_tok_s, decode_tok_s=res.decode_tok_s,
                peak_gib=peak_gib, err_forward=err_fwd, err_plain=err_plain,
                err_fp32=err_fp32, requests=n_req, prompt_len=prompt_len, max_new=max_new,
                phase_s=time.perf_counter() - t_phase), model


# The scan families' whole-path check, at a small lr: the kernel path against
# the plain path in fp32 compute (the paths differ in the order of sums only;
# the olmo-1b check's limits on scalars, mu, nu and w) and in bf16 compute,
# which the models run. In bf16 the two paths also round to bf16 at other
# places, and the moments' largest differences after 3 steps are as large
# between the plain path in bf16 and in fp32 (bf16_own: 0.38 of max|mu| for
# rwkv6, 0.030 for zamba2 on the H100), so no limit on their max tells a wrong
# kernel from rounding. Their bulk does: the median |d| over the median
# |moment| (as w's bulk), held to MOMENT_BULK_MARGIN times the same ratio of
# bf16_own from the same init (on the H100: rwkv6 mu 0.0027 against its
# own 0.0092, zamba2 0.0300 against 0.0312). The control, the kernel path
# with its weights rounded to COARSE_BITS significant bits (two fewer than
# bf16's), must fail that limit.
MOMENT_BULK_MARGIN, COARSE_BITS = 2.0, 6


def moment_bulk(cmp: dict) -> dict:
    """median |d| / median |moment| of mu and nu (compare_runs' quantiles)."""
    return {k: cmp[k]["q_abs"][0] / max(cmp[k]["q_change"][0], 1e-30) for k in ("mu", "nu")}


def scan_whole_check(tag: str, model: str, cfg, layers: int, batch: int, seq: int) -> dict:
    """The whole kernel path against the plain path (see MOMENT_BULK_MARGIN)
    for `cfg` cut to `layers` layers at batch x seq; prints the comparisons
    and fails the run if they disagree or the control meets the limit.
    Returns the comparisons, w's and the moments' bulk and the moments'
    limits."""
    def run(compute, plain, w0=None, coarse_bits=0):
        ccfg = dataclasses.replace(cfg, n_layers=layers, compute_dtype=compute)
        return check_run(WHOLE_CHECK_LR, plain, w0, to_host=True, coarse_bits=coarse_bits,
                         cfg=ccfg, batch=batch, seq=seq)

    plain32 = run("float32", True)
    w0 = plain32[2]
    kern = run("float32", False, w0)
    whole = {"fp32": compare_runs(plain32[:2], kern[:2], w0)}
    del kern
    plain16 = run("bfloat16", True, w0)
    whole["bf16_own"] = compare_runs(plain32[:2], plain16[:2], w0)
    del plain32
    kern = run("bfloat16", False, w0)
    whole["bf16"] = compare_runs(plain16[:2], kern[:2], w0)
    del kern
    kern = run("bfloat16", False, w0, COARSE_BITS)
    whole["bf16_coarse"] = compare_runs(plain16[:2], kern[:2], w0)
    del kern, plain16, w0
    w_bulk = {k: whole[k]["w"]["q_abs"][0] / whole[k]["w"]["q_change"][0]
              for k in ("fp32", "bf16")}
    bulk = {k: moment_bulk(whole[k]) for k in ("bf16_own", "bf16", "bf16_coarse")}
    limit = {k: MOMENT_BULK_MARGIN * v for k, v in bulk["bf16_own"].items()}
    ok = all(v <= (COSINE_ABS_TOL if k == "ascent_cosine_abs" else SCALAR_REL_TOL)
             for name in ("fp32", "bf16") for row in whole[name]["steps"]
             for k, v in row.items())
    ok &= all(whole["fp32"][k]["max_rel"] <= MOMENT_REL_TOL[k] for k in ("mu", "nu"))
    ok &= all(v <= W_BULK_TOL for v in w_bulk.values())
    ok &= all(bulk["bf16"][k] <= limit[k] for k in limit)
    print(f"{tag} train check, whole kernel path vs plain path ({layers} layers, batch {batch} "
          f"x {seq}, {TRAIN_CHECK_STEPS} steps, lr {WHOLE_CHECK_LR}; fp32 and bf16 compute, "
          f"bf16's own error (the plain path in bf16 vs in fp32) and the control (the kernel "
          f"path, weights at {COARSE_BITS} bits, vs the plain path in bf16)): "
          f"{json.dumps(whole)}; w bulk {w_bulk}; moments' bulk {json.dumps(bulk)}, bf16 held "
          f"to {json.dumps(limit)} ({MOMENT_BULK_MARGIN} x bf16_own's); tolerances otherwise "
          f"the olmo-1b check's")
    if not ok:
        fail(f"{model} training on the kernel path disagrees with the plain path")
    if not any(bulk["bf16_coarse"][k] > limit[k] for k in limit):
        fail(f"{model} whole-path check: the coarse-weights control meets the moments' limit")
    return dict(whole=whole, w_bulk=w_bulk, moment_bulk=bulk, moment_limit=limit)


# Training: full width at 4 layers (1,411,620,864 parameters); the whole-path
# check at 2 layers and batch 2 x 512, where autograd of the plain scan fits
RWKV_TRAIN_LAYERS, RWKV_CHECK_LAYERS, RWKV_CHECK_BATCH, RWKV_CHECK_SEQ = 4, 2, 2, 512


def rwkv_per_step(cfg) -> dict:
    """Scan launches of one AsyncSAM step: 2 gradient passes, each running
    every block's forward once, and again in backward when the block is
    checkpointed, and every block's backward once."""
    fwd = 1 if cfg.remat == "none" else 2
    return {"rwkv6_scan_fwd": 2 * fwd * cfg.n_layers, "rwkv6_scan_bwd": 2 * cfg.n_layers}


def rwkv_lockstep(ex, state, pipe) -> dict:
    """One step through the kernels, every wkv call (forward and backward,
    every layer, both passes) held against its plain version on its inputs."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as r6

    launch_fwd, launch_bwd = r6._launch_fwd, r6._launch_bwd
    worst = {"rwkv6_scan_fwd": {"calls": 0, "ok": True, "max_rel_err": 0.0},
             "rwkv6_scan_bwd": {"calls": 0, "ok": True, "max_rel_err": 0.0}}

    def note(name, pairs, tol):
        worst[name]["calls"] += 1
        for a, e in pairs:
            worst[name]["ok"] &= wkv_ok(a, e, tol)
            worst[name]["max_rel_err"] = max(worst[name]["max_rel_err"], wkv_error(a, e)[1])

    def fwd(r, k, v, w, u, s0):
        got = launch_fwd(r, k, v, w, u, s0)
        with torch.no_grad():
            note("rwkv6_scan_fwd", zip(got, ref.rwkv6_scan_plain(r, k, v, w, u, s0)),
                 RWKV_FP32_TOL)
        return got

    def bwd(r, k, v, w, u, s0, dy, ds):
        got = launch_bwd(r, k, v, w, u, s0, dy, ds)
        note("rwkv6_scan_bwd", zip(got, plain_wkv_grads(r, k, v, w, u, s0, dy, ds)),
             RWKV_GRAD_TOL)
        return got

    r6._launch_fwd, r6._launch_bwd = fwd, bwd
    try:
        ex.step(state, pipe.peek())
    finally:
        r6._launch_fwd, r6._launch_bwd = launch_fwd, launch_bwd
    torch.cuda.empty_cache()
    return worst


def rwkv_train_phase() -> dict:
    """Train full-width rwkv6 at RWKV_TRAIN_LAYERS layers through the
    kernels; then the lockstep check of one step and the whole-path check."""
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.engine import Engine, ThroughputMeter
    from repro_torch.launch.train import kernel_launches

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("rwkv6-7b"), n_layers=RWKV_TRAIN_LAYERS)
    _, ex, state, pipe = build_trainer(TRAIN_STEPS, LR, cfg=cfg)
    n_params = sum(b.numel() for b in state.params.buffers)
    print(f"rwkv train: rwkv6-7b at full width, {cfg.n_layers} layers, {n_params} params in "
          f"{len(state.params.buffers)} bucket(s), compute {cfg.compute_dtype}, remat "
          f"{cfg.remat}; batch {TRAIN_BATCH} x {TRAIN_SEQ}, b' = "
          f"{max(1, round(TRAIN_BATCH * ASCENT_FRACTION))}; adamw, lr {LR}")
    meter = ThroughputMeter(tokens_per_batch=TRAIN_BATCH * TRAIN_SEQ)
    reset_launches()                                   # counts: 0 just before
    torch.cuda.reset_peak_memory_stats()
    report = Engine(ex, pipe, [meter]).fit(state, TRAIN_STEPS)
    launches = kernel_launches(family="ssm")           # read just after
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    hist = report.metrics_history
    for i, m in enumerate(hist):
        print(f"rwkv train step {i}: {json.dumps(m)} ({meter.step_times[i]:.4f} s)")
    per_step = rwkv_per_step(cfg)
    want = {**{k: n * TRAIN_STEPS for k, n in per_step.items()},
            **{k: TRAIN_STEPS for k in PATH_KERNELS["adamw"]}}
    print(f"rwkv train launches over {TRAIN_STEPS} steps: {launches}; per step: {per_step} "
          f"(remat {cfg.remat!r}: 2 gradient passes x 2 forwards and 1 backward per block)")
    if launches != {k: want.get(k, 0) for k in launches}:
        fail(f"rwkv train: launches {launches}, expected {want} and no other kernel")
    if report.steps_done != TRAIN_STEPS or not all(
            math.isfinite(v) for m in hist for v in m.values()):
        fail(f"rwkv train: training did not finish with finite metrics: {hist}")
    if [m["perturbed"] for m in hist] != [0.0] + [1.0] * (TRAIN_STEPS - 1):
        fail(f"rwkv train: perturbed should be 0 then 1: {[m['perturbed'] for m in hist]}")
    step_s = statistics.median(meter.step_times[2:])
    out = dict(layers=cfg.n_layers, params=n_params, steps=TRAIN_STEPS,
               step_times_s=meter.step_times, median_step_s=step_s,
               descent_tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s, peak_gib=peak_gib,
               launches=launches, per_step=per_step, loss_first=hist[0]["loss"],
               loss_last=hist[-1]["loss"])
    print(f"rwkv train: median step (steps 2-{TRAIN_STEPS - 1}) {step_s:.4f} s, "
          f"{out['descent_tokens_per_s']:.1f} descent tok/s, peak {peak_gib:.2f} GiB")
    final = report.final_state
    out["profile"] = train_profile(ex, final, pipe)
    del report, state, final
    torch.cuda.empty_cache()

    # lockstep: every wkv call of one step against its plain version
    _, ex, state, pipe = build_trainer(TRAIN_STEPS, LR, cfg=cfg)
    lock = rwkv_lockstep(ex, state, pipe)
    del ex, state, pipe
    torch.cuda.empty_cache()
    calls_ok = {k: v["calls"] for k, v in lock.items()} == per_step
    print(f"rwkv train check, lockstep (the first step; each wkv call vs its plain version "
          f"on its inputs): {json.dumps(lock)}; tolerance: fp32 outputs {RWKV_FP32_TOL} (the "
          f"forward) and {RWKV_GRAD_TOL} (the gradients) of their max, bf16 outputs the bf16 "
          f"tolerance; calls per step {per_step}")
    if not (calls_ok and all(v["ok"] for v in lock.values())):
        fail("a wkv kernel call on the rwkv6 training path disagrees with its plain version")
    out["lockstep"] = lock

    # whole path: kernels against plain versions at a small lr
    out.update(scan_whole_check("rwkv", "rwkv6", cfg, RWKV_CHECK_LAYERS, RWKV_CHECK_BATCH,
                                RWKV_CHECK_SEQ), phase_s=time.perf_counter() - t_phase)
    return out


# ---------------------------------------------------------------------------
# zamba2: the Mamba2 SSD scan kernels, serving zamba2-1.2b, training it
# ---------------------------------------------------------------------------

# (name, (B, S, H, P, N, G), dtype of x/b/c, init_state, fast decay): the
# model's scan shape (8 x 1024 tokens, 64 heads, P = N = 64, one group;
# prefill and the descent batch of training), the ascent batch's (2 x 1024:
# half of a step's backward calls), a decode step (one token from the
# carried state), a ragged S from a state, G = 2 groups over H = 4 heads in
# fp32, and a head whose decay exp(dt a) = exp(20 x -16) underflows to 0. dt,
# a and d are fp32, as the model passes them.
M2_CASES = [
    ("zamba2-1.2b scan", (8, 1024, 64, 64, 64, 1), "bfloat16", False, False),
    ("zamba2-1.2b ascent scan", (2, 1024, 64, 64, 64, 1), "bfloat16", False, False),
    ("decode step, S=1 from a state", (8, 1, 64, 64, 64, 1), "bfloat16", True, False),
    ("ragged S=1000 from a state", (8, 1000, 64, 64, 64, 1), "bfloat16", True, False),
    ("G=2, H=4 fp32", (2, 512, 4, 64, 64, 2), "float32", True, False),
    ("a=-16, dt=20: the decay underflows", (2, 512, 64, 64, 64, 1), "float32", True, True),
]
# fp32 outputs (the state, ddt, da, dd, d init_state; y, dx, db, dc in fp32)
# within 2e-4 of their max: the reference's own limit for its kernel against
# its sequential oracle (tests/test_kernels.py), the sums' order differing
# (chunks of 64 against the plain version's 128); bf16 outputs also round once
# to bf16 (the reference's bf16 tolerance, relative to the max). da, a sum
# over B and S of terms that can cancel to a small da, is held to the same
# 2e-4 against the plain scan in float64 (m2_da_f64): its own da in
# fp32 is up to 2e-4 of max|da| from it (the G = 2 case), too close to the
# limit to judge the kernel by.
M2_TOL = 2e-4
M2_PLAIN_CHUNK = 128                        # the model's chunk_size (the plain version's)


def m2_inputs(shape, dtype: str, init: bool, fast: bool, seed: int = 5):
    """x ~ 0.5 N(0, 1) and b, c ~ 0.3 N(0, 1) in `dtype`; dt = softplus(N(0,
    1)), a = -linspace(1, 16, H) (the model's init), d = 0.5 in fp32; with
    `fast` the last head's dt is 20; init_state ~ 0.5 N(0, 1) or None."""
    import torch
    b, s, h, p, n, g = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*sh, scale=1.0):
        return torch.randn(sh, generator=gen, device="cuda") * scale

    tdt = getattr(torch, dtype)
    x = rnd(b, s, h, p, scale=0.5).to(tdt)
    dt = torch.nn.functional.softplus(rnd(b, s, h))
    if fast:
        dt[..., -1] = 20.0
    a = -torch.linspace(1.0, 16.0, h, device="cuda")
    bb, cc = rnd(b, s, g, n, scale=0.3).to(tdt), rnd(b, s, g, n, scale=0.3).to(tdt)
    d = torch.full((h,), 0.5, device="cuda")
    return x, dt, a, bb, cc, d, (rnd(b, h, p, n, scale=0.5) if init else None)


# fp32 ops per state element and step that the function needs: the least
# over its forms, which is the recurrence's (a chunked form adds its (T, T)
# products, more of them the longer its chunk, so its count would describe a
# kernel, not the function). Forward (5): the decay multiply, the xd B^T
# multiply-add and the y = h C multiply-add. Backward (14), with h rebuilt
# from the initial state: the rebuild (3), the dh carry (3: the dy C^T
# multiply-add and the decay), dxd = dh B, dB = dh^T xd, dC = h^T dy and dla
# = sum(dh h) (2 each).
M2_FWD_OPS, M2_BWD_OPS = 5, 14


def m2_flops(shape, backward: bool) -> float:
    """fp32 operations the SSD scan needs on this shape (M2_FWD_OPS or
    M2_BWD_OPS per state element and step)."""
    b, s, h, p, n, _ = shape
    return float((M2_BWD_OPS if backward else M2_FWD_OPS) * b * s * h * p * n)


def m2_bound(shape, dtype: str, init: bool, backward: bool) -> tuple[float, str]:
    """Least time for the work: every input read once, every output written
    once, against the operations the function needs (m2_flops) at fp32's
    rate on the CUDA cores."""
    b, s, h, p, n, g = shape
    es = 2 if dtype == "bfloat16" else 4
    tok = b * s
    state = 4 * b * h * p * n
    inputs = tok * h * p * es + tok * h * 4 + 2 * h * 4 + 2 * tok * g * n * es
    inputs += state if init else 0
    if backward:     # + dy, dh_T; out dx, ddt, da, dd, db, dc, d init_state
        nbytes = inputs + tok * h * p * es + state + tok * h * p * es + tok * h * 4 \
            + 2 * h * 4 + 2 * tok * g * n * es + state
    else:            # out y, the final state
        nbytes = inputs + tok * h * p * es + state
    return bound(nbytes, m2_flops(shape, backward))


def m2_fwd_phase_ms(x, dt, a, b, c, d, s0) -> dict:
    """Device time of each phase of the SSD forward launched alone (CUDA
    events), on buffers that one whole forward filled first; with one chunk
    "out" is the whole forward and the other phases launch nothing."""
    from repro_torch.kernels import mamba2_scan as m2
    bufs = m2.fwd_buffers(x, b)
    m2.run_fwd(x, dt, a, b, c, d, s0, bufs)
    return {name: time_ms(lambda bit=bit: m2.run_fwd(x, dt, a, b, c, d, s0, bufs, bit))
            for name, bit in m2.FWD_PHASES.items()}


def m2_bwd_phase_ms(x, dt, a, b, c, d, s0, dy, ds) -> dict:
    """Device time of each phase of the SSD backward launched alone (CUDA
    events), on buffers that one whole backward filled first."""
    from repro_torch.kernels import mamba2_scan as m2
    bufs = m2.bwd_buffers(x, b)
    m2.run_bwd(x, dt, a, b, c, d, s0, dy, ds, bufs)
    return {name: time_ms(lambda bit=bit: m2.run_bwd(x, dt, a, b, c, d, s0, dy, ds, bufs, bit))
            for name, bit in m2.BWD_PHASES.items()}


def plain_m2_grads(x, dt, a, b, c, d, s0, dy, ds):
    """Autograd of the plain chunked scan, PLAIN_GRAD_BATCH batch rows at a
    time; da and dd (summed over b) summed."""
    import torch
    from repro_torch.kernels import ref
    parts = []
    for i in range(0, x.shape[0], PLAIN_GRAD_BATCH):
        sl = slice(i, i + PLAIN_GRAD_BATCH)
        parts.append(ref.mamba2_scan_plain_grads(
            x[sl], dt[sl], a, b[sl], c[sl], d, None if s0 is None else s0[sl],
            None if dy is None else dy[sl], None if ds is None else ds[sl],
            chunk=M2_PLAIN_CHUNK))
    return tuple(torch.stack([p[j] for p in parts]).sum(0) if j in (2, 5)
                 else torch.cat([p[j] for p in parts]) for j in range(7))


def m2_da_f64(*args):
    """da of the plain scan in float64 (plain_m2_grads' arguments): the
    witness the kernels' da is held against."""
    return plain_m2_grads(*(None if t is None else t.double() for t in args))[2].float()


def mamba2_kernel_phase() -> dict:
    """Both SSD kernels against their plain versions at M2_CASES, timed;
    returns the model shape's row per kernel."""
    import torch
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import ref

    main_rows, failures = {}, []
    for ci, (case, shape, dtype, init, fast) in enumerate(M2_CASES):
        x, dt, a, b, c, d, s0 = m2_inputs(shape, dtype, init, fast)
        y, state = m2.mamba2_scan(x, dt, a, b, c, d, s0)
        again = m2.mamba2_scan(x, dt, a, b, c, d, s0)
        torch.cuda.synchronize()
        same = torch.equal(y, again[0]) and torch.equal(state, again[1])
        del again
        y_p, state_p = ref.mamba2_chunked_plain(x, dt, a, b, c, d, chunk=M2_PLAIN_CHUNK,
                                                init_state=s0)
        finite = bool(torch.isfinite(y.float()).all() and torch.isfinite(state).all())
        ok = same and finite and wkv_ok(y, y_p, M2_TOL) and wkv_ok(state, state_p, M2_TOL)
        errs = {"y": wkv_error(y, y_p), "state": wkv_error(state, state_p)}
        del y, state, y_p, state_p
        ms = time_ms(lambda: m2.mamba2_scan(x, dt, a, b, c, d, s0))
        plain_ms = time_ms(lambda: ref.mamba2_chunked_plain(
            x, dt, a, b, c, d, chunk=M2_PLAIN_CHUNK, init_state=s0), 0.0)
        bound_ms, bound_by = m2_bound(shape, dtype, init, backward=False)
        tf32_ms = m2_flops(shape, False) / 495e12 * 1e3
        rows = {"mamba2_scan_fwd": dict(
            kernel="mamba2_scan_fwd", case=case, shape=shape, dtype=dtype, init_state=init,
            max_abs_err=max(e[0] for e in errs.values()),
            max_rel_err={k: e[1] for k, e in errs.items()}, deterministic=same, ok=ok, ms=ms,
            plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
            tf32_ops_ms=tf32_ms, phase_ms=m2_fwd_phase_ms(x, dt, a, b, c, d, s0))}

        gen = torch.Generator(device="cuda").manual_seed(6)
        dy = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
        ds = torch.randn((shape[0], shape[2], shape[3], shape[4]), generator=gen, device="cuda")
        got = m2._launch_bwd(x, dt, a, b, c, d, s0, dy, ds)
        again = m2._launch_bwd(x, dt, a, b, c, d, s0, dy, ds)
        torch.cuda.synchronize()
        same = all(torch.equal(u, v) for u, v in zip(got, again))
        del again
        want = list(plain_m2_grads(x, dt, a, b, c, d, s0, dy, ds))
        want[2] = m2_da_f64(x, dt, a, b, c, d, s0, dy, ds)
        names = ("dx", "ddt", "da", "db", "dc", "dd", "d_init_state")
        errs = {n_: wkv_error(u, e) for n_, u, e in zip(names, got, want)}
        ok_b = same and all(u.shape == e.shape and u.dtype == e.dtype
                            and bool(torch.isfinite(u.float()).all()) and wkv_ok(u, e, M2_TOL)
                            for u, e in zip(got, want))
        del got, want
        ms = time_ms(lambda: m2._launch_bwd(x, dt, a, b, c, d, s0, dy, ds))
        plain_ms = time_ms(lambda: plain_m2_grads(x, dt, a, b, c, d, s0, dy, ds), 0.0)
        bound_ms, bound_by = m2_bound(shape, dtype, init, backward=True)
        rows["mamba2_scan_bwd"] = dict(
            kernel="mamba2_scan_bwd", case=case, shape=shape, dtype=dtype, init_state=init,
            max_abs_err=max(e[0] for e in errs.values()),
            max_rel_err={n_: e[1] for n_, e in errs.items()}, deterministic=same, ok=ok_b,
            ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
            tf32_ops_ms=m2_flops(shape, True) / 495e12 * 1e3,
            phase_ms=m2_bwd_phase_ms(x, dt, a, b, c, d, s0, dy, ds))
        for name, row in rows.items():
            print("mamba2 " + json.dumps(row))
            if not row["ok"]:
                failures.append(f"{name} / {case}")
            if ci == 0:
                main_rows[name] = row
        del x, dt, a, b, c, d, s0, dy, ds
        torch.cuda.empty_cache()
    if failures:
        fail(f"mamba2 kernels disagree with their plain versions: {failures}")
    return main_rows


def zamba_launches() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_scan as m2
    return {"flash_attention": fa.launches, **m2.launches}


def zamba_serve_phase():
    """Serve full-width, full-depth zamba2-1.2b through the kernels and
    check the logits. Returns (summary dict, model)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenTask
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model, transformer

    t_phase = time.perf_counter()
    n_req, prompt_len, max_new = 8, 1024, 32
    cfg = get_config("zamba2-1.2b")
    n_inv = -(-cfg.n_layers // cfg.hybrid.period)
    t0 = time.perf_counter()
    model = build_model(cfg).init(seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"zamba2-1.2b init on the card: {time.perf_counter() - t0:.3f}s, "
          f"{sum(p.numel() for p in model.parameters())} params ({cfg.param_dtype}), "
          f"compute {cfg.compute_dtype}; {cfg.n_layers} mamba layers, {n_inv} invocations "
          f"of the shared attention block")
    prompts = TokenTask(cfg.vocab_size, seed=0).sample(n_req, prompt_len)
    serve(cfg, model, prompts, 2)                         # warm-up, not counted

    reset_launches()                                      # counts: 0 just before
    torch.cuda.reset_peak_memory_stats()
    res = serve(cfg, model, prompts, max_new)
    launches = zamba_launches()                           # read just after
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"zamba2 serve: prefill {n_req}x{prompt_len} in {res.prefill_s:.4f}s "
          f"({res.prefill_tok_s:.1f} tok/s); decode {max_new - 1} steps in "
          f"{res.decode_s:.4f}s ({res.decode_tok_s:.1f} tok/s); peak {peak_gib:.2f} GiB; "
          f"launches {launches} (serve's own count {res.launches})")
    # a prefill: one scan a mamba layer, one flash launch an invocation; a
    # decoded token: one scan a mamba layer (decode attention is plain)
    want = {"flash_attention": n_inv, "mamba2_scan_fwd": cfg.n_layers * max_new,
            "mamba2_scan_bwd": 0}
    if launches != want or res.launches != {k: want[k] for k in res.launches}:
        fail(f"zamba2 serving launched {launches}, expected {want}")
    if res.tokens.shape != (n_req, max_new) or res.logits.shape != (n_req, max_new,
                                                                     cfg.vocab_size):
        fail(f"unexpected output shapes {tuple(res.tokens.shape)} {tuple(res.logits.shape)}")
    if not bool(torch.isfinite(res.logits).all()):
        fail("non-finite zamba2 logits")

    # prefill + stepwise decode == one full forward over the same tokens
    full_tokens = torch.cat([torch.as_tensor(prompts, device="cuda").long(),
                             res.tokens[:, :-1]], dim=1)
    with torch.inference_mode():
        full, _ = transformer.forward(model, {"tokens": full_tokens}, cfg)
    err_fwd = rel_err(res.logits, full[:, prompt_len - 1:])
    del full
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
    print(f"zamba2 serve check (max|d|/max|ref|): prefill+decode vs forward {err_fwd:.3e}; "
          f"kernel vs plain prefill {err_plain:.3e} (tolerance {MODEL_BF16_REL_TOL}); "
          f"fp32 compute kernel vs plain {err_fp32:.3e} (tolerance {MODEL_FP32_REL_TOL}); "
          f"bf16 error itself: bf16 plain vs fp32 plain {rel_err(plain16, plain32):.3e}")
    if not (err_fwd <= MODEL_BF16_REL_TOL and err_plain <= MODEL_BF16_REL_TOL
            and err_fp32 <= MODEL_FP32_REL_TOL):
        fail("zamba2 serving logits disagree")
    return dict(launches=launches, prefill_s=res.prefill_s, decode_s=res.decode_s,
                prefill_tok_s=res.prefill_tok_s, decode_tok_s=res.decode_tok_s,
                peak_gib=peak_gib, err_forward=err_fwd, err_plain=err_plain,
                err_fp32=err_fp32, requests=n_req, prompt_len=prompt_len, max_new=max_new,
                phase_s=time.perf_counter() - t_phase), model


# The whole-path check at full width, 8 layers (two invocations of the shared
# block) and batch 2 x 512, where autograd of the plain scan and attention fit
ZAMBA_CHECK_LAYERS, ZAMBA_CHECK_BATCH, ZAMBA_CHECK_SEQ = 8, 2, 512


def zamba_per_step(cfg) -> dict:
    """Launches of one AsyncSAM step: 2 gradient passes; each runs every
    mamba block's scan once, and again in backward when the block is
    checkpointed, its backward once, and flash once an invocation of the
    shared block (not checkpointed, as in the reference)."""
    fwd = 1 if cfg.remat == "none" else 2
    n_inv = -(-cfg.n_layers // cfg.hybrid.period)
    return {"flash_attention": 2 * n_inv, "mamba2_scan_fwd": 2 * fwd * cfg.n_layers,
            "mamba2_scan_bwd": 2 * cfg.n_layers}


def zamba_lockstep(ex, state, pipe) -> dict:
    """One step through the kernels, every SSD call (forward and backward,
    every layer, both passes) held against its plain version on its inputs."""
    import torch
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import ref

    launch_fwd, launch_bwd = m2._launch_fwd, m2._launch_bwd
    worst = {"mamba2_scan_fwd": {"calls": 0, "ok": True, "max_rel_err": 0.0},
             "mamba2_scan_bwd": {"calls": 0, "ok": True, "max_rel_err": 0.0}}

    def note(name, pairs):
        worst[name]["calls"] += 1
        for u, e in pairs:
            worst[name]["ok"] &= wkv_ok(u, e, M2_TOL)
            worst[name]["max_rel_err"] = max(worst[name]["max_rel_err"], wkv_error(u, e)[1])

    def fwd(x, dt, a, b, c, d, s0):
        got = launch_fwd(x, dt, a, b, c, d, s0)
        with torch.no_grad():
            note("mamba2_scan_fwd", zip(got, ref.mamba2_chunked_plain(
                x, dt, a, b, c, d, chunk=M2_PLAIN_CHUNK, init_state=s0)))
        return got

    def bwd(x, dt, a, b, c, d, s0, dy, ds):
        got = launch_bwd(x, dt, a, b, c, d, s0, dy, ds)
        want = list(plain_m2_grads(x, dt, a, b, c, d, s0, dy, ds))
        want[2] = m2_da_f64(x, dt, a, b, c, d, s0, dy, ds)
        note("mamba2_scan_bwd", zip(got, want))
        return got

    m2._launch_fwd, m2._launch_bwd = fwd, bwd
    try:
        ex.step(state, pipe.peek())
    finally:
        m2._launch_fwd, m2._launch_bwd = launch_fwd, launch_bwd
    torch.cuda.empty_cache()
    return worst


def zamba_train_phase() -> dict:
    """Train full-width, full-depth zamba2-1.2b through the kernels; then
    the lockstep check of one step and the whole-path check."""
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.engine import Engine, ThroughputMeter
    from repro_torch.launch.train import kernel_launches

    t_phase = time.perf_counter()
    cfg = get_config("zamba2-1.2b")
    _, ex, state, pipe = build_trainer(TRAIN_STEPS, LR, cfg=cfg)
    n_params = sum(b.numel() for b in state.params.buffers)
    print(f"zamba2 train: zamba2-1.2b at full width and depth, {n_params} params in "
          f"{len(state.params.buffers)} bucket(s), compute {cfg.compute_dtype}, remat "
          f"{cfg.remat}; batch {TRAIN_BATCH} x {TRAIN_SEQ}, b' = "
          f"{max(1, round(TRAIN_BATCH * ASCENT_FRACTION))}; adamw, lr {LR}")
    meter = ThroughputMeter(tokens_per_batch=TRAIN_BATCH * TRAIN_SEQ)
    reset_launches()                                   # counts: 0 just before
    torch.cuda.reset_peak_memory_stats()
    report = Engine(ex, pipe, [meter]).fit(state, TRAIN_STEPS)
    launches = kernel_launches(family="hybrid")        # read just after
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    hist = report.metrics_history
    for i, m in enumerate(hist):
        print(f"zamba2 train step {i}: {json.dumps(m)} ({meter.step_times[i]:.4f} s)")
    per_step = zamba_per_step(cfg)
    want = {**{k: n * TRAIN_STEPS for k, n in per_step.items()},
            **{k: TRAIN_STEPS for k in PATH_KERNELS["adamw"]}}
    print(f"zamba2 train launches over {TRAIN_STEPS} steps: {launches}; per step: {per_step} "
          f"(remat {cfg.remat!r} on the mamba blocks: 2 gradient passes x 2 scans and 1 "
          f"backward per mamba block, 1 flash per invocation of the shared block)")
    if launches != {k: want.get(k, 0) for k in launches}:
        fail(f"zamba2 train: launches {launches}, expected {want} and no other kernel")
    if report.steps_done != TRAIN_STEPS or not all(
            math.isfinite(v) for m in hist for v in m.values()):
        fail(f"zamba2 train: training did not finish with finite metrics: {hist}")
    if [m["perturbed"] for m in hist] != [0.0] + [1.0] * (TRAIN_STEPS - 1):
        fail(f"zamba2 train: perturbed should be 0 then 1: {[m['perturbed'] for m in hist]}")
    step_s = statistics.median(meter.step_times[2:])
    out = dict(layers=cfg.n_layers, params=n_params, steps=TRAIN_STEPS,
               step_times_s=meter.step_times, median_step_s=step_s,
               descent_tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s, peak_gib=peak_gib,
               launches=launches, per_step=per_step, loss_first=hist[0]["loss"],
               loss_last=hist[-1]["loss"])
    print(f"zamba2 train: median step (steps 2-{TRAIN_STEPS - 1}) {step_s:.4f} s, "
          f"{out['descent_tokens_per_s']:.1f} descent tok/s, peak {peak_gib:.2f} GiB")
    final = report.final_state
    out["profile"] = train_profile(ex, final, pipe)
    del report, state, final
    torch.cuda.empty_cache()

    # lockstep: every SSD call of one step against its plain version
    _, ex, state, pipe = build_trainer(TRAIN_STEPS, LR, cfg=cfg)
    lock = zamba_lockstep(ex, state, pipe)
    del ex, state, pipe
    torch.cuda.empty_cache()
    calls_ok = {k: v["calls"] for k, v in lock.items()} == {
        k: per_step[k] for k in ("mamba2_scan_fwd", "mamba2_scan_bwd")}
    print(f"zamba2 train check, lockstep (the first step; each SSD call vs its plain version "
          f"on its inputs): {json.dumps(lock)}; tolerance: fp32 outputs {M2_TOL} of their "
          f"max, bf16 outputs the bf16 tolerance; calls per step {per_step}")
    if not (calls_ok and all(v["ok"] for v in lock.values())):
        fail("an SSD kernel call on the zamba2 training path disagrees with its plain version")
    out["lockstep"] = lock

    # whole path: kernels against plain versions at a small lr
    out.update(scan_whole_check("zamba2", "zamba2", cfg, ZAMBA_CHECK_LAYERS, ZAMBA_CHECK_BATCH,
                                ZAMBA_CHECK_SEQ), phase_s=time.perf_counter() - t_phase)
    return out


# ---------------------------------------------------------------------------
# the other dense configs (gemma-2b, qwen3-8b, qwen2.5-32b) and the method
# variants (gsam, looksam, esam, aesam, mesa)
# ---------------------------------------------------------------------------

DENSE_SERVE_ARCHS = ("gemma-2b", "qwen3-8b", "qwen2.5-32b")
DENSE_TRAIN_ARCHS = ("gemma-2b", "qwen3-8b")
# Serving keeps the fp32 weights and casts a layer's at use. Beside them the
# phase needs one full forward's logits (8 x 1056 x vocab in bf16, 2.6-4.3 GB),
# the fp32-compute prefills' activations and the plain attention's fp32
# scores: a config deeper than its fp32 weights plus this much is cut.
SERVE_HEADROOM_GIB = 16
# Training takes the deepest cut whose peak, extrapolated from one step at 1
# and at 2 layers, leaves this share of the card free.
TRAIN_HEADROOM = 0.10
# bf16 over 18-36 layers: each of these models' serving logits (prefill +
# decode against one forward, the kernel path against the plain path) is held
# to DENSE_BF16_MARGIN times bf16's own error on its weights (the plain path
# in bf16 against it in fp32, max|d| / max|ref|), as the scan families'
# moments are; the control, the kernel path with its weights at
# DENSE_COARSE_BITS significant bits, must exceed that limit. On the H100
# bf16's own error is 3.4e-2 (gemma-2b) to 5.7e-2 (qwen3-8b) and the kernel
# path 0.78-0.90 of it; weights at 6 bits gave 2.0-2.4 times it, qwen3-8b's
# 1.119e-1 against its limit of 1.132e-1, so the control takes 5 bits.
DENSE_BF16_MARGIN, DENSE_COARSE_BITS = 2.0, 5


def param_count(cfg, layers: int) -> int:
    from repro_torch.models import analytic_param_count
    return analytic_param_count(dataclasses.replace(cfg, n_layers=layers))


def serve_depth(cfg) -> int:
    """The deepest cut of `cfg` (all of it if it fits) whose fp32 weights
    leave SERVE_HEADROOM_GIB of the card."""
    import torch
    budget = torch.cuda.get_device_properties(0).total_memory - SERVE_HEADROOM_GIB * 2**30
    one, two = param_count(cfg, 1), param_count(cfg, 2)
    return max(1, min(cfg.n_layers, 1 + int((budget / 4 - one) // (two - one))))


def dense_serve_phase(arch: str) -> dict:
    """Serve `arch` (full width; full depth, or the deepest cut that fits)
    through the kernels: the launch count, prefill + decode against one
    forward, the kernel path against the plain path in bf16 and in fp32
    compute, the profile, then the coarse-weights control."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenTask
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model, transformer

    t_phase = time.perf_counter()
    n_req, prompt_len, max_new = 8, 1024, 32
    full_cfg = get_config(arch)
    cfg = dataclasses.replace(full_cfg, n_layers=serve_depth(full_cfg))
    cut = ("full depth" if cfg.n_layers == full_cfg.n_layers else
           f"depth cut to {cfg.n_layers} of {full_cfg.n_layers} layers (fp32 weights + "
           f"{SERVE_HEADROOM_GIB} GiB of the card)")
    t0 = time.perf_counter()
    model = build_model(cfg).init(seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{arch} serve: init on the card {time.perf_counter() - t0:.3f}s, {n_params} params "
          f"({cfg.param_dtype}, {4 * n_params / 2**30:.2f} GiB; full depth "
          f"{param_count(full_cfg, full_cfg.n_layers)}), {cut}, compute {cfg.compute_dtype}")
    prompts = TokenTask(cfg.vocab_size, seed=0).sample(n_req, prompt_len)
    serve(cfg, model, prompts, 2)                         # warm-up, not counted

    reset_launches()                                      # counts: 0 just before
    torch.cuda.reset_peak_memory_stats()
    res = serve(cfg, model, prompts, max_new)
    launches = {"flash_attention": fa.launches}           # read just after
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"{arch} serve: prefill {n_req}x{prompt_len} in {res.prefill_s:.4f}s "
          f"({res.prefill_tok_s:.1f} tok/s); decode {max_new - 1} steps in {res.decode_s:.4f}s "
          f"({res.decode_tok_s:.1f} tok/s); peak {peak_gib:.2f} GiB; launches {launches}")
    if launches["flash_attention"] != cfg.n_layers:
        fail(f"{arch}: flash_attention launched {launches['flash_attention']} times in one "
             f"prefill, expected n_layers={cfg.n_layers}")
    if res.tokens.shape != (n_req, max_new) or res.logits.shape != (n_req, max_new,
                                                                     cfg.vocab_size):
        fail(f"{arch}: unexpected output shapes {tuple(res.tokens.shape)} "
             f"{tuple(res.logits.shape)}")
    if not bool(torch.isfinite(res.logits).all()):
        fail(f"{arch}: non-finite logits")

    full_tokens = torch.cat([torch.as_tensor(prompts, device="cuda").long(),
                             res.tokens[:, :-1]], dim=1)
    with torch.inference_mode():
        fwd, _ = transformer.forward(model, {"tokens": full_tokens}, cfg)
    err_fwd = rel_err(res.logits, fwd[:, prompt_len - 1:])
    del fwd
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
    own = rel_err(plain16, plain32)
    limit = DENSE_BF16_MARGIN * own
    profile_phase(model)
    with torch.no_grad():                                 # the control, last: it spoils
        for p in model.parameters():                      # the weights
            coarsen_(p.data, DENSE_COARSE_BITS)
    err_coarse = rel_err(prefill_logits(cfg, "kernel"), plain16)
    print(f"{arch} serve check (max|d|/max|ref|): prefill+decode vs forward {err_fwd:.3e}; "
          f"kernel vs plain prefill {err_plain:.3e}; both held to {DENSE_BF16_MARGIN} x bf16's "
          f"own error (bf16 plain vs fp32 plain {own:.3e}) = {limit:.3e}; fp32 compute kernel "
          f"vs plain {err_fp32:.3e} (tolerance {MODEL_FP32_REL_TOL}); control, weights at "
          f"{DENSE_COARSE_BITS} bits vs plain {err_coarse:.3e} (must exceed the limit)")
    if not (err_fwd <= limit and err_plain <= limit and err_fp32 <= MODEL_FP32_REL_TOL):
        fail(f"{arch} serving logits disagree")
    if err_coarse <= limit:
        fail(f"{arch} serve check: the coarse-weights control meets the limit")
    out = dict(arch=arch, layers=cfg.n_layers, full_layers=full_cfg.n_layers, params=n_params,
               launches=launches, prefill_s=res.prefill_s, decode_s=res.decode_s,
               prefill_tok_s=res.prefill_tok_s, decode_tok_s=res.decode_tok_s,
               peak_gib=peak_gib, err_forward=err_fwd, err_plain=err_plain, err_fp32=err_fp32,
               bf16_own=own, limit=limit, err_coarse=err_coarse)
    del model, plain16, plain32, kernel32, res
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def probe_peak(cfg, layers: int) -> int:
    """Peak device bytes of one AsyncSAM AdamW step of `cfg` cut to `layers`
    layers at the train phase's batch, its state included."""
    import gc
    import torch
    _, ex, state, pipe = build_trainer(1, LR, cfg=dataclasses.replace(cfg, n_layers=layers))
    batch = pipe.peek()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ex.step(state, batch)
    peak = torch.cuda.max_memory_allocated()
    del ex, state, pipe, batch
    gc.collect()
    torch.cuda.empty_cache()
    return peak


def train_depth(cfg) -> tuple[int, dict]:
    """The deepest cut of `cfg` whose step's peak, extrapolated linearly in
    the depth from probes at 1 and 2 layers, leaves TRAIN_HEADROOM of the
    card. Returns (layers, the probes)."""
    import torch
    total = torch.cuda.get_device_properties(0).total_memory
    p1, p2 = probe_peak(cfg, 1), probe_peak(cfg, 2)
    layers = 1 + int(((1 - TRAIN_HEADROOM) * total - p1) // (p2 - p1))
    layers = max(1, min(cfg.n_layers, layers))
    return layers, dict(peak_1_layer_gib=p1 / 2**30, peak_2_layers_gib=p2 / 2**30,
                        card_gib=total / 2**30, predicted_peak_gib=(p1 + (layers - 1)
                                                                    * (p2 - p1)) / 2**30)


def dense_train_phase(arch: str) -> dict:
    """Train `arch` at full width and the deepest depth that fits, 6
    AsyncSAM AdamW steps through FusedExecutor + Engine: the launch counts,
    the profile of one step, then the lockstep check of one step at half
    that depth (room for the check's copies of w, mu and nu)."""
    import gc
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.engine import Engine, ThroughputMeter
    from repro_torch.launch.train import kernel_launches

    t_phase = time.perf_counter()
    full_cfg = get_config(arch)
    layers, probes = train_depth(full_cfg)
    cfg = dataclasses.replace(full_cfg, n_layers=layers)
    _, ex, state, pipe = build_trainer(TRAIN_STEPS, LR, cfg=cfg)
    n_params = sum(b.numel() for b in state.params.buffers)
    print(f"{arch} train: full width, depth cut to {layers} of {full_cfg.n_layers} layers "
          f"(probes {json.dumps(probes)}; headroom {TRAIN_HEADROOM}), {n_params} params, "
          f"compute {cfg.compute_dtype}, remat {cfg.remat}; batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"b' = {max(1, round(TRAIN_BATCH * ASCENT_FRACTION))}; adamw, lr {LR}")
    meter = ThroughputMeter(tokens_per_batch=TRAIN_BATCH * TRAIN_SEQ)
    reset_launches()                                   # counts: 0 just before
    torch.cuda.reset_peak_memory_stats()
    report = Engine(ex, pipe, [meter]).fit(state, TRAIN_STEPS)
    launches = kernel_launches()                       # read just after
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    hist = report.metrics_history
    for i, m in enumerate(hist):
        print(f"{arch} train step {i}: {json.dumps(m)} ({meter.step_times[i]:.4f} s)")
    flash_n, how = flash_per_step(cfg)
    want = {"flash_attention": flash_n * TRAIN_STEPS,
            **{k: TRAIN_STEPS for k in PATH_KERNELS["adamw"]}}
    print(f"{arch} train launches over {TRAIN_STEPS} steps: {launches}; flash per step: {how}")
    if launches != {k: want.get(k, 0) for k in launches}:
        fail(f"{arch} train: launches {launches}, expected {want} and no other kernel")
    if report.steps_done != TRAIN_STEPS or not all(
            math.isfinite(v) for m in hist for v in m.values()):
        fail(f"{arch} train: training did not finish with finite metrics: {hist}")
    if [m["perturbed"] for m in hist] != [0.0] + [1.0] * (TRAIN_STEPS - 1):
        fail(f"{arch} train: perturbed should be 0 then 1: {[m['perturbed'] for m in hist]}")
    step_s = statistics.median(meter.step_times[2:])
    out = dict(arch=arch, layers=layers, full_layers=full_cfg.n_layers, params=n_params,
               probes=probes, steps=TRAIN_STEPS, step_times_s=meter.step_times,
               median_step_s=step_s, descent_tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
               peak_gib=peak_gib, launches=launches, flash_per_step=flash_n,
               loss_first=hist[0]["loss"], loss_last=hist[-1]["loss"])
    print(f"{arch} train: median step (steps 2-{TRAIN_STEPS - 1}) {step_s:.4f} s, "
          f"{out['descent_tokens_per_s']:.1f} descent tok/s, peak {peak_gib:.2f} GiB "
          f"(predicted {probes['predicted_peak_gib']:.2f})")
    final = report.final_state
    out["profile"] = train_profile(ex, final, pipe, tag=f"{arch} adamw")
    del ex, state, pipe, report, final
    gc.collect()
    torch.cuda.empty_cache()

    check_layers = max(1, layers // 2)
    lock = lockstep_check(steps=1, cfg=dataclasses.replace(cfg, n_layers=check_layers))
    print(f"{arch} train check, lockstep (one step at {check_layers} layers, lr {LR}; each "
          f"epilogue kernel call vs its plain version on the same inputs): {json.dumps(lock)}; "
          f"tolerance rel {LOCKSTEP_REL_TOL}, one call and one launch each")
    if not all(r["calls"] == r["launches"] == 1 and r["max_rel_err"] <= LOCKSTEP_REL_TOL
               for r in lock.values()):
        fail(f"an epilogue kernel on the {arch} training path disagrees with its plain version")
    out.update(lockstep=lock, lockstep_layers=check_layers,
               phase_s=time.perf_counter() - t_phase)
    return out


# Full-width, full-depth olmo-1b trains each variant through FusedExecutor +
# Engine as the launcher builds it (AdamW at lr 3e-3, rho 0.05, batch 8 x
# 1024), for enough steps to show its branches: LookSAM (k 2) fresh, reuse,
# fresh, reuse; AE-SAM past its 8 forced SAM steps; MESA's term on from step 2.
VARIANT_STEPS = {"gsam": 3, "looksam": 4, "esam": 3, "aesam": 10, "mesa": 4}
VARIANT_MKW = {"looksam": {"looksam_k": 2}, "mesa": {"mesa_start_step": 2}}
WEIGHT_KERNELS = ("sq_norm", "sam_perturb", "fused_axpy", "fused_dot_norms", "adamw_epilogue")
# the methods whose every weight-space kernel call is held to its plain
# version, and over how many steps (LookSAM's: a fresh and a reuse step)
VARIANT_LOCKSTEP = {"gsam": 1, "looksam": 2}


def variant_per_step(method: str, m: dict, cfg) -> dict:
    """The launches one step of `method` makes on one fp32 bucket, by the
    branch its metrics `m` report: a SAM-like step takes two gradient
    passes, LookSAM's reuse and AE-SAM's SGD step one, MESA one and a forward
    at the EMA under no_grad (no remat rerun)."""
    fwd = 1 if cfg.remat == "none" else 2
    sam_like = {"gsam": True, "esam": True, "looksam": m.get("fresh") == 1.0,
                "aesam": m.get("sam_step") == 1.0, "mesa": False}[method]
    out = dict.fromkeys(WEIGHT_KERNELS, 0)
    out["adamw_epilogue"] = 1
    out["sq_norm"] = 2 if (sam_like or method == "aesam") else 1
    out["sam_perturb"] = 1 if sam_like else 0
    if method == "looksam":
        out["fused_axpy"] = out["fused_dot_norms"] = 1
    passes = 2 if sam_like else 1
    out["flash_attention"] = passes * fwd * cfg.n_layers + (cfg.n_layers if method == "mesa"
                                                            else 0)
    return out


def carried_bytes(tree) -> int:
    """Device bytes of the tensors in a method's state."""
    from repro_torch.utils import buckets
    if buckets.is_bucketed(tree):
        return sum(b.numel() * b.element_size() for b in tree.buffers)
    if hasattr(tree, "numel") and hasattr(tree, "element_size"):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(carried_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(carried_bytes(v) for v in tree)
    return 0


def esam_mask_check(beta: float) -> dict:
    """ESAM's mask drawn over olmo-1b's parameter bucket on the card: one
    byte an element, density beta within 5 binomial standard deviations."""
    import torch
    from repro_torch.core.variants import esam_mask
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    mask = esam_mask({"w": torch.empty(1, device="cuda").expand(OLMO_1B_BUCKET)}, beta,
                     torch.Generator(device="cuda").manual_seed(0))["w"]
    mask_bytes = torch.cuda.memory_allocated() - before
    density = float(mask.sum(dtype=torch.int64)) / OLMO_1B_BUCKET
    sigma = math.sqrt(beta * (1 - beta) / OLMO_1B_BUCKET)
    out = dict(elements=OLMO_1B_BUCKET, bytes=mask_bytes, density=density, beta=beta,
               sigmas=(density - beta) / sigma)
    print(f"variant esam mask at olmo-1b's bucket: {json.dumps(out)}")
    del mask
    if mask_bytes > OLMO_1B_BUCKET + 2**21 or abs(density - beta) > 5 * sigma:
        fail(f"esam mask: {out}; expected one byte an element and density {beta} within "
             f"5 sigma")
    return out


def variants_phase() -> dict:
    """Each variant at full-width, full-depth olmo-1b: its launches every
    step against its branch, finite metrics and its branches' own checks,
    step time, peak memory and the state it carries, one profiled step; then
    every weight-space kernel call of gsam's and looksam's steps against
    its plain version."""
    import gc
    import statistics
    import torch
    from repro_torch.engine import Callback, Engine, ThroughputMeter
    from repro_torch.launch.train import kernel_launches

    class StepLaunches(Callback):
        """Each step's launches: the counts' difference across the step."""

        def __init__(self):
            self.last, self.rows = kernel_launches(), []

        def on_step(self, engine, state, metrics, step_time_s):
            now = kernel_launches()
            self.rows.append({k: now[k] - self.last[k] for k in now})
            self.last = now

    t_phase = time.perf_counter()
    out = {}
    for method, steps in VARIANT_STEPS.items():
        t0 = time.perf_counter()
        mkw = VARIANT_MKW.get(method, {})
        cfg, ex, state, pipe = build_trainer(steps, LR, method=method, mkw=mkw)
        reset_launches()                               # counts: 0 just before
        meter, per_step = ThroughputMeter(tokens_per_batch=TRAIN_BATCH * TRAIN_SEQ), StepLaunches()
        torch.cuda.reset_peak_memory_stats()
        report = Engine(ex, pipe, [meter, per_step]).fit(state, steps)
        launches = kernel_launches()                   # read just after
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        hist = report.metrics_history
        final = report.final_state
        row = dict(resident=ex.resident, steps=steps, mkw=mkw, launches=launches,
                   per_step=per_step.rows, step_times_s=meter.step_times,
                   median_step_s=statistics.median(meter.step_times[1:]), peak_gib=peak_gib,
                   carried_bytes=carried_bytes(final.method_state),
                   loss_first=hist[0]["loss"], loss_last=hist[-1]["loss"])
        for i, (m, got) in enumerate(zip(hist, per_step.rows)):
            want = variant_per_step(method, m, cfg)
            print(f"variant {method} step {i}: {json.dumps(m)} ({meter.step_times[i]:.4f} s); "
                  f"launches {json.dumps({k: got[k] for k in want})}")
            if {k: got[k] for k in got if got[k] or k in want} != want:
                fail(f"variant {method} step {i}: launches {got}, expected {want}")
        if report.steps_done != steps or not all(
                math.isfinite(v) for m in hist for v in m.values()):
            fail(f"variant {method}: training did not finish with finite metrics: {hist}")
        if ex.resident != (method == "gsam"):
            fail(f"variant {method}: resident {ex.resident}; gsam alone is resident")
        if method == "looksam" and [m["fresh"] for m in hist] != [1.0, 0.0] * (steps // 2):
            fail(f"looksam (k 2): fresh {[m['fresh'] for m in hist]}, expected 1, 0, 1, 0")
        if method == "aesam":
            mcfg = ex.method.cfg
            mean, var, zs = 0.0, 1.0, []          # z as the step computes it, from gnorm_sq
            for m in hist:
                zs.append((m["gnorm_sq"] - mean) / (math.sqrt(var) + 1e-12))
                mean, var = (mcfg.aesam_ema * mean + (1 - mcfg.aesam_ema) * m["gnorm_sq"],
                             mcfg.aesam_ema * var
                             + (1 - mcfg.aesam_ema) * (m["gnorm_sq"] - mean) ** 2)
            row["z"], row["sam_step"] = zs, [m["sam_step"] for m in hist]
            print(f"variant aesam: sam_step {row['sam_step']}; z {zs}; lambda_hi "
                  f"{mcfg.aesam_lambda_hi}")
            want = [1.0 if (i < 8 or z > mcfg.aesam_lambda_hi) else 0.0
                    for i, z in enumerate(zs)]
            if row["sam_step"] != want:
                fail(f"aesam: sam_step {row['sam_step']}, expected {want} from z")
        if method == "esam":
            row["mask"] = esam_mask_check(ex.method.cfg.esam_beta)
        if method == "mesa":
            mcfg = ex.method.cfg
            if not all(m["mesa_kl"] > 0 for m in hist[mcfg.mesa_start_step:]):
                fail(f"mesa: mesa_kl {[m['mesa_kl'] for m in hist]} not > 0 once active")
            if not all(m["loss"] > m["ce"] for m in hist[mcfg.mesa_start_step:]):
                fail("mesa: the distillation term is not in the loss once active")
        row["profile"] = train_profile(ex, final, pipe, tag=f"variant {method}")
        print(f"variant {method}: resident {ex.resident}; median step {row['median_step_s']:.4f} s "
              f"(steps 1-{steps - 1}), peak {peak_gib:.2f} GiB, carried state "
              f"{row['carried_bytes']} bytes; in the profiled step copy kernels "
              f"{row['profile']['copy_us']:.1f} us, memcpys {row['profile']['memcpy_us']:.1f} "
              f"us, host reads {row['profile']['host_read_us']:.1f} us")
        del ex, state, pipe, report, final
        gc.collect()
        torch.cuda.empty_cache()
        if method in VARIANT_LOCKSTEP:
            n = VARIANT_LOCKSTEP[method]
            lock = lockstep_check(names=WEIGHT_KERNELS, steps=n, method=method, mkw=mkw)
            print(f"variant {method} check, lockstep ({n} step(s), lr {LR}; every weight-space "
                  f"kernel call vs its plain version on the same inputs): {json.dumps(lock)}; "
                  f"tolerance rel {LOCKSTEP_REL_TOL}")
            if not all(r["calls"] == r["launches"] and r["max_rel_err"] <= LOCKSTEP_REL_TOL
                       for r in lock.values()):
                fail(f"a weight-space kernel on the {method} path disagrees with its plain "
                     f"version")
            row["lockstep"] = lock
        row["phase_s"] = time.perf_counter() - t0
        print(f"variant {method} phase: {row['phase_s']:.2f}s")
        out[method] = row
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def device_time_by_kernel(prof) -> dict:
    from torch.autograd import DeviceType
    by_name: dict[str, list] = {}
    for e in prof.events():                            # device-side kernels only
        if e.device_type == DeviceType.CUDA:
            tot = by_name.setdefault(e.name, [0.0, 0])
            tot[0] += e.time_range.elapsed_us()
            tot[1] += 1
    return by_name


def train_profile(ex, state, pipe, family: str = "adamw", tag: str = "") -> dict:
    """Device time by kernel over one training step, its busy share, the
    epilogue kernels' share, the device time of copy kernels (casts, and
    copies between dtypes) and of device-to-device memcpys (a per-leaf
    state's gathers into buckets and scatters back go there), and the host's
    time in reads of a device value (`aten::_local_scalar_dense`, each
    waiting for the device)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = pipe.peek()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ex.step(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = device_time_by_kernel(prof)
    busy_us = sum(t for t, _ in by_name.values())
    tags = {"sq_norm": "sq_norm_kernel", "sam_perturb": "perturb_kernel",
            "fused_axpy": "axpy_kernel",
            "fused_dot_norms": "dot_norms_kernel", "adamw_epilogue": "adamw_epilogue_kernel",
            "sgd_epilogue": "sgd_epilogue_kernel", "flash_attention": "fa_fwd_",
            "rwkv6_scan_fwd": "wkv_fwd_kernel", "rwkv6_scan_bwd": "wkv_bwd_kernel",
            "mamba2_scan_fwd": "ssd_fwd_", "mamba2_scan_bwd": "ssd_bwd_"}
    ours = {k: sum(t for n, (t, _) in by_name.items() if tag in n) for k, tag in tags.items()}
    epi_us = sum(ours[k] for k in PATH_KERNELS[family])
    memcpy_us = sum(t for n, (t, _) in by_name.items() if n.startswith("Memcpy"))
    copy_us = sum(t for n, (t, _) in by_name.items() if "copy" in n.lower())
    read_us = sum(e.cpu_time_total for e in prof.key_averages()
                  if e.key == "aten::_local_scalar_dense")
    print(f"profile train {tag or family} step: wall {wall_us:.1f} us, device kernels "
          f"{busy_us:.1f} us (busy {100 * busy_us / wall_us:.1f}%), {len(by_name)} kernel "
          f"names; epilogue kernels {epi_us:.1f} us = {100 * epi_us / wall_us:.2f}% of the "
          f"step, {100 * epi_us / busy_us:.2f}% of device time; copy kernels {copy_us:.1f} us, "
          f"memcpys {memcpy_us:.1f} us; host reads {read_us:.1f} us; by kernel (us): "
          f"{json.dumps(ours)}")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {t:12.1f} us {100 * t / busy_us:5.1f}%  {n:5d}x  {name[:110]}")
    return dict(wall_us=wall_us, busy_us=busy_us, epilogue_us=epi_us, by_kernel_us=ours,
                copy_us=copy_us, memcpy_us=memcpy_us, host_read_us=read_us)


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
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import rwkv6_scan as r6
    from repro_torch.kernels import sam_perturb as sp

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    libs = build.build([fa.SOURCE, sp.SOURCE, fu.SOURCE, r6.SOURCE, m2.SOURCE])
    print(f"build: {len(libs)} kernel source(s) in {time.perf_counter() - t0:.2f}s")
    for src, lib in libs.items():
        log = lib.with_name(lib.name + ".log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {src.name}: {line.strip()}")

    epilogue = epilogue_phase()
    flash = flash_phase()
    served, model = serve_phase()
    print("serve " + json.dumps(served))
    profile_phase(model)
    del model
    torch.cuda.empty_cache()

    trained, ex, state, pipe = train_phase()
    print("train " + json.dumps(trained))
    train_profile(ex, state, pipe)
    del ex, state, pipe
    torch.cuda.empty_cache()
    print("train check " + json.dumps(train_check()))
    guarded = guard_phase(trained["median_step_s"])
    print("guard " + json.dumps(guarded))
    print(f"guard phase: {guarded['phase_s']:.2f}s")

    sgd_trained, ex, state, pipe = train_phase("sgd")
    print("train sgd " + json.dumps(sgd_trained))
    train_profile(ex, state, pipe, "sgd")
    del ex, state, pipe
    torch.cuda.empty_cache()
    sgd_check()
    restarted = restart_phase()

    t0 = time.perf_counter()
    delta = delta_phase()
    print(f"delta kernel phase: {time.perf_counter() - t0:.2f}s")
    # the remote phase's server imports this file for its loss
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    remote = remote_phase()
    print(f"remote phase: {remote['phase_s']:.2f}s")
    hetero = hetero_phase()
    print(f"hetero phase: {hetero['phase_s']:.2f}s")

    t0 = time.perf_counter()
    wkv = rwkv_kernel_phase()
    print(f"rwkv kernel phase: {time.perf_counter() - t0:.2f}s")
    rwkv_served, model = rwkv_serve_phase()
    print("rwkv serve " + json.dumps(rwkv_served))
    profile_phase(model)
    del model
    torch.cuda.empty_cache()
    print(f"rwkv serve phase: {rwkv_served['phase_s']:.2f}s")
    rwkv_trained = rwkv_train_phase()
    print("rwkv train " + json.dumps(rwkv_trained))
    print(f"rwkv train phase: {rwkv_trained['phase_s']:.2f}s")

    t0 = time.perf_counter()
    ssd = mamba2_kernel_phase()
    print(f"mamba2 kernel phase: {time.perf_counter() - t0:.2f}s")
    zamba_served, model = zamba_serve_phase()
    print("zamba2 serve " + json.dumps(zamba_served))
    profile_phase(model)
    del model
    torch.cuda.empty_cache()
    print(f"zamba2 serve phase: {zamba_served['phase_s']:.2f}s")
    zamba_trained = zamba_train_phase()
    print("zamba2 train " + json.dumps(zamba_trained))
    print(f"zamba2 train phase: {zamba_trained['phase_s']:.2f}s")

    dense_served, dense_trained = {}, {}
    for arch in DENSE_SERVE_ARCHS:
        dense_served[arch] = dense_serve_phase(arch)
        print(f"{arch} serve " + json.dumps(dense_served[arch]))
        print(f"{arch} serve phase: {dense_served[arch]['phase_s']:.2f}s")
    for arch in DENSE_TRAIN_ARCHS:
        dense_trained[arch] = dense_train_phase(arch)
        print(f"{arch} train " + json.dumps(dense_trained[arch]))
        print(f"{arch} train phase: {dense_trained[arch]['phase_s']:.2f}s")
    variants = variants_phase()
    print("variants " + json.dumps(variants))
    print(f"variants phase: {variants['phase_s']:.2f}s")
    # the launches of these paths, each counted from 0 just before it
    new_paths = ([r["launches"] for r in dense_served.values()]
                 + [r["launches"] for r in dense_trained.values()]
                 + [variants[m]["launches"] for m in VARIANT_STEPS] + [guarded["launches"]])

    kernels = [dict(name="flash_attention", route="cuda",
                    source="src/repro_torch/csrc/flash_attention.cu",
                    replaces="src/repro/kernels/flash_attention.py:36",
                    launches=served["launches"]["flash_attention"]
                    + trained["launches"]["flash_attention"]
                    + zamba_served["launches"]["flash_attention"]
                    + zamba_trained["launches"]["flash_attention"]
                    + sum(p["flash_attention"] for p in new_paths),
                    max_abs_err=flash["max_abs_err"], ms=flash["ms"],
                    plain_ms=flash["plain_ms"], bound_ms=flash["bound_ms"],
                    bound_by=flash["bound_by"], library_ms=flash["library_ms"])]
    replaces = {"sq_norm": ("sam_perturb.cu", "src/repro/kernels/sam_perturb.py:36"),
                "sam_perturb": ("sam_perturb.cu", "src/repro/kernels/sam_perturb.py:56"),
                "fused_axpy": ("fused_update.cu", "src/repro/kernels/fused_update.py:50"),
                "fused_dot_norms": ("fused_update.cu", "src/repro/kernels/fused_update.py:76"),
                "adamw_epilogue": ("fused_update.cu", "src/repro/kernels/fused_update.py:239"),
                "sgd_epilogue": ("fused_update.cu", "src/repro/kernels/fused_update.py:178")}
    # each kernel's launches on the paths that run it: the AdamW train phase,
    # the SGD train phase, the SAM path of the restart phase, the remote
    # phase (the delta kernels), the dense train phases and the variants
    path_launches = {**trained["launches"],
                     "sgd_epilogue": sgd_trained["launches"]["sgd_epilogue"],
                     "sam_perturb": restarted["sam_launches"]["sam_perturb"]}
    for name, where in (("delta_amax", "src/repro/kernels/fused_update.py:107"),
                        ("delta_encode_i8", "src/repro/kernels/fused_update.py:134")):
        replaces[name] = ("fused_update.cu", where)
        epilogue[name] = delta[name]
        path_launches[name] = remote["launches"][name]
    for name in path_launches:
        path_launches[name] += sum(p.get(name, 0) for p in new_paths)
    for name, (src, where) in replaces.items():
        row = epilogue[name]
        kernels.append(dict(name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
                            replaces=where, launches=path_launches[name],
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    # the scan's launches on the rwkv6 paths: serving (forward) and training
    for name in ("rwkv6_scan_fwd", "rwkv6_scan_bwd"):
        row = wkv[name]
        kernels.append(dict(name=name, route="cuda", source="src/repro_torch/csrc/rwkv6_scan.cu",
                            replaces="src/repro/kernels/rwkv6_scan.py:30",
                            launches=rwkv_served["launches"][name]
                            + rwkv_trained["launches"][name],
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    # the SSD scan's launches on the zamba2 paths: serving and training
    for name in ("mamba2_scan_fwd", "mamba2_scan_bwd"):
        row = ssd[name]
        kernels.append(dict(name=name, route="cuda", source="src/repro_torch/csrc/mamba2_scan.cu",
                            replaces="src/repro/kernels/mamba2_scan.py:28",
                            launches=zamba_served["launches"][name]
                            + zamba_trained["launches"][name],
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"], library_ms=row["library_ms"]))
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
