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
   unaligned cases; deepseek-v2-lite's MLA prefill at batch 8, mixtral's
   2 x 8192 prefill with its 4096-token window, phi-3-vision's hd 96 and
   whisper-tiny's 6 heads of 64, non-causal (encoder, cross) and causal
   (decoder self), and the local heads of the tensor-parallel layout:
   olmo-1b's 16 heads on a 2- and a 16-way "model" axis (8 and 1),
   qwen3-8b's 32/8 on 4 (8/2), deepseek's MLA on 1 of its 16 heads and
   mixtral's 2 of 32 query heads on their one kv head with the window, each
   timed beside its full-head case), each case's launch counted and the
   case also held to the kernel path it must take: wgmma (TMA + wgmma) for
   every shape of the model paths;
4b. flash offset phase: the kernel with a query offset at the rank shapes
   of the "fsdp_sp" profile on a 16-way "model" axis (a rank's block of the
   queries against the whole sequence's keys: qwen2.5-32b train_4k's 256 of
   4096 queries at ranks 0, 7 and 15, its prefill_32k's 2048 of 32768 at
   rank 15, zamba2-1.2b's shared attention, 32 heads of 64, 256 of 4096 at
   rank 15; and the other families "fsdp_sp" reaches: deepseek's MLA,
   hd 192 / hd_v 128, mixtral's 4096-token window on prefill_32k's last
   block, phi-3-vision's hd 96 and whisper-tiny's non-causal encoder
   block), each held to the plain version with the same offset within
   BF16_TOL on the wgmma path, its launch counted, and timed beside its
   bound (the pairs its rows see) and SDPA with the equivalent boolean
   mask;
4c. expert share phase: one full-width MoE layer of deepseek-v2-lite (16 EP
   shares of 4 experts, its shared experts in 16 column shares) and of
   mixtral (16 expert-TP shares of 896 columns) at x 8 x 1024, bf16: the
   shares computed one after another through `models.moe.moe_share` from
   one routing and summed, held against the whole `moe_apply` within
   BF16_TOL of its max, forward and the gradients of x, the router and
   we_in (no route can flip: the routing is one); one share's time beside
   the whole layer's;
4d. block decode phase: mixtral's GQA decode with its window and
   deepseek's absorbed MLA decode over a 65,536-position cache in 16
   blocks, and whisper-tiny's cross-attention decode over 32,768 encoder
   positions in 16 blocks (every position valid), each block's part on one
   card merged by `utils.distributed.lse_merge` (the combine `lse_combine`
   does across ranks), held against the whole decode within FP32_TOL of
   its max, the blocks that see no key counted (14 of mixtral's 16, none of
   whisper's); timed beside the whole;
4e. moe block phase: one full-width mixtral MoE layer on 16 sequence
   blocks of 2 x 4096 tokens as the "fsdp_sp" profile's ranks compute it
   (each block routed on its rows, each route ranked after the row's
   earlier blocks' routes to its expert, the whole row's capacity 1280;
   bf16, x skewed so that routes drop): the routes and ranks that differ
   from the whole layer's must be 0 (`route_flips`), the dropped routes
   the same, y within BF16_TOL of its max, the aux from the blocks' sums
   within FP32_TOL; one block's forward timed beside the whole layer's;
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
8b. elastic phase: the launcher's code under --elastic on a world-1 NCCL
   group: olmo-1b at full width and 2 layers trains 8 AsyncSAM AdamW steps
   through `make_host_mesh` (a 1-device mesh: bucket-resident, the
   kernels), `FusedExecutor(mesh=, model_cfg=)`, `ElasticExecutor`, a
   `CheckpointCallback` saving every 2 steps and `Engine.fit(events=)`, with
   a resize to 1 device at step 2, a grow to 2 at step 4 that one card
   cannot meet (skipped) and a crash at step 5 restored onto the survivor:
   the final params, mu, nu and carried ascent gradient equal the
   uninterrupted run's bit for bit, one restart, two resizes, mesh_devices 1
   every step, and every step's launches (counts 0 just before, read just
   after; the replayed steps too) those of the AdamW path; prints the
   resize and restore times;
8c. dry-run phase: the train phase's step traced on fake tensors on the card
   (`FusedExecutor.abstract_state` + `lower`, the kernels as custom ops with
   fake shapes): its kernels must be the train phase's launches a step, its
   predicted peak within DRYRUN_PEAK_TOL of the train phase's
   max_memory_allocated, and it prints the predicted flops over the median
   step; then `launch.dryrun.run_cell` on the card's path for production
   cells (olmo-1b train_4k on 16x16 at 1 and 2 layers, qwen2.5-32b
   train_4k on 2x16x16 at a depth cut and decode_32k on 16x16 at 1 and 2
   layers, zamba2-1.2b long_500k, deepseek-v2-lite-16b prefill_32k), each
   record printed, and the mesh layout's three checks: olmo-1b's rank-0
   flops at full depth (from its two cuts) at most an eighth of the
   data-parallel layout's 754.3 TFLOP, qwen2.5-32b's train peak at its cut
   at least the cut's share of 100 GiB below the old layout's record
   there, and its decode_32k peak at full depth (from its two cuts: the
   "fsdp_sp" cache on its sequence blocks) within one 80 GB card; the traces must leave memory_allocated and, after a
   reset, max_memory_allocated unchanged; then the custom ops' dispatch cost
   (flash and the AdamW epilogue through the dispatcher against their launch
   called directly, host time a call, in turns);
9. delta kernel phase: delta_amax and delta_encode_i8 at the epilogue
   phase's sizes (the olmo-1b bucket included), p in fp32 and bf16, and with
   a NaN and an inf in p, held to their plain versions exactly and timed;
10. remote phase (Form B across processes, the slice's main path): olmo-1b
   at full width and 3 layers (6, the deepest whose snapshot fits the
   wire's 2 GiB frame, before the examples phase came in) trains 3
   lockstep SGD-momentum AsyncSAM steps (a snapshot and two int8 deltas)
   through `RemoteExecutor(serve_ascent=True, job_compress="int8")`, its ascent server
   spawned on the card in a second process; every delta kernel call is held
   to its plain version on its inputs, the launches are counted (0 just
   before, read just after), and the client's shadow must equal a numpy
   replay of the snapshot and every int8 payload bit for bit; prints each
   exchange's bytes and times and both processes' peak memory; it runs with
   the lane ladder on and a tracker: lane_state 0 every step, the
   ascent_rpc spans counted;
11. hetero phase: olmo-1b at full width and 2 layers, 8 x 256 tokens, the descent on the
   card and the ascent lane a CPU thread, calibrated (t_fast, t_slow, b'/b),
   then steps until a fresh ascent gradient was harvested: the tau schedule,
   stale reuses and SGD fallbacks; the lanes' spans go to a Chrome trace
   (build/hetero_trace.json) and its hidden-perturbation fraction is printed
   (`repro_torch.obs.compute_overlap`);
11b. examples phase: `repro_torch.examples.quickstart` and
   `hetero_async_sam` through their `main()` on the card at their default
   sizes (the latter's ascent lane on the CPU): each one's final loss, wall
   time and launches (counts 0 just before, read just after: quickstart's
   flash launches and AdamW epilogues as its steps imply); quickstart's
   loss must fall, every run's loss be finite and its accuracy above chance;
12. rwkv kernel phase: the wkv scan's forward and backward kernels at
   rwkv6-7b's scan shape (8 x 1024 tokens, 64 heads of 64, bf16 r/k/v, fp32
   decay and bonus), a one-token decode step from a state, a ragged S and
   K = V = 16 in fp32, held against the plain scan and autograd of it (the
   forward run twice: the same bits), and timed beside their bound (the
   plain versions on one warm call by CUDA events); the forward kernel's
   registers and spills (ptxas) printed;
12b. rwkv local heads phase: both wkv kernels on a rank's 4 of the 64
   heads (rwkv6's "tp" layout on a 16-way "model" axis) at the scan shape,
   their inputs strided views of the whole call's, held against the plain
   versions on 2 of the 8 rows and timed beside the whole 64-head call and
   their bound;
12c. rwkv share phase: one full-width rwkv6-7b layer's time mix in 16 head
   shares and channel mix in 16 d_ff shares (`models.rwkv` on
   `partitioning.rwkv_share`: each share's gate on its 256 columns of the
   summed value, joined), summed in bf16 rank after rank where the
   program's collectives move bf16 (the time-mix output, the value, each
   mix's gradient of x), bf16 at x 2 x 1024, held against the whole layer
   within BF16_TOL of its max, forward and the gradients of x and of every
   leaf; a rank's forward timed beside the whole layer's;
12d. rwkv column share phase: one full-width rwkv6-7b time mix in 128
   column shares of 32 (the "tp" layout where "model" divides d_model but
   not the 64 heads: half a head a share; `models.rwkv`'s
   `timemix_project` / `timemix_scan` / `timemix_gate_out` on
   `partitioning.rwkv_share`): each share's r, k, v and g on its columns,
   r, k and v joined whole, the decay and the wkv kernels on every head on
   each share, its columns of y through its rows of wo, the outputs and
   x's gradients summed in fp32 and rounded once (as the branch's f and g
   sum them), bf16 at x 2 x 1024: forward and the gradients of x and of
   every leaf within BF16_TOL of the whole `timemix_apply`'s max; the same
   two sums added in bf16 rank after rank, as 128 ranks' ring all-reduces
   of bf16 would add them, reported beside (why the branch sums in fp32); a
   control, each share's gradient of the joined r, k and v its own alone
   (not summed over the shares), must miss; a share's forward timed
   beside the whole time mix's;
12e. rwkv chain phase: the wkv kernels over a 2 x 4096 sequence of
   rwkv6-7b's 64 heads of 64 (bf16 r/k/v, slow decays) cut into 16 blocks
   as the "fsdp_sp" profile's ranks run them: each block from no state,
   the per-key prefix of the entering states (`state_prefix`), each block
   again from its state; y, the final state and the gradients by autograd
   (the backward kernel through both passes) held to one whole-sequence
   call (the scan phase's tolerances); a control without the chain must
   miss; launches counted; forward and backward timed beside the whole
   call's;
13. rwkv serve phase: full-width, full-depth rwkv6-7b (7,534,813,184 fp32
   parameters from seed 0, bf16 compute) serves 8 x 1024 prompts + 32 greedy
   tokens through `launch.serve.serve`: 32 forward launches per prefill and
   per decoded token (counts 0 just before, read just after); prefill +
   stepwise decode against one forward, the kernel path against the plain
   path in bf16 and fp32 compute; then its profile as in 5, the prefill's
   kernels also read from the profiler's event tree and the two readings
   printed side by side;
14. rwkv train phase: rwkv6-7b at full width and 2 layers trains 6 AsyncSAM
   AdamW steps through `FusedExecutor` + `Engine` (remat "full": 8 forward
   and 4 backward scan launches a step, each epilogue kernel once); one step
   profiled; every wkv call of one step held against its plain version on
   its inputs; the whole kernel path against the plain path at a small lr,
   1 layer, batch 2 x 256, in fp32 and bf16 compute (bf16's moments held
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
15b. chained scan phase: the SSD kernels at zamba2-1.2b's width (8 x 1024
   and 2 x 1024, fp32 x/b/c) cut into 4 sequence blocks as the "fsdp_sp"
   profile's ranks run them: each block from no state, the pure prefix of
   the entering states (`utils.distributed.state_prefix`), each block again
   from its state; y, the final state and the gradients by autograd (the
   backward kernel through both passes and the prefix) held to one
   whole-sequence kernel call within FP32_TOL of their max; the chain's
   launches counted and its time beside the whole call's;
15c. mamba share phase: one full-width zamba2-1.2b mamba2 layer in 16
   "tp" shares of 4 heads (`ssm.mamba2_gated` / `mamba2_out` on
   `partitioning.mamba_share`), the gated norm's sums of squares added in
   fp32 and the outputs and x's gradients in bf16 rank after rank, as the
   collectives sum them, at x 2 x 1024: forward and the gradients of x and
   of every leaf within BF16_TOL of the whole layer's max; a control, the
   norm over each share's own columns, must miss; a rank's forward timed
   beside the whole layer's;
15d. SSD local heads phase: both SSD kernels on a rank's 4 of 64 heads at
   the scan shape (8 x 1024, B and C whole), held to the plain versions
   and timed beside the whole call and their bound;
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
18. serve phases, one function for every config: gemma-2b, qwen3-8b,
   deepseek-v2-lite-16b, phi-3-vision-4.2b and whisper-tiny at full depth,
   qwen2.5-32b and mixtral-8x7b at the deepest cut whose fp32 weights leave
   16 GiB of the card, each serving 8 x 1024 prompts (mixtral 2 x 8192, so
   its 4096-token window binds in prefill and decode) + 32 greedy tokens
   through `launch.serve.serve` with the launcher's zero stub inputs (fp32
   weights from seed 0, bf16 compute): the depth and its cuts, tokens/s,
   peak memory, the flash launches of one prefill (one a layer; whisper's
   encoder layers plus its decoder's self- and cross-attention; counts 0
   just before, read just after); prefill + stepwise decode against one
   forward over the same tokens (the MoE models at capacity factor 8, where
   no route drops, with the routes decode and the forward disagree on
   counted) and the kernel path against the plain path, both held to twice
   bf16's own error on the model's weights (the plain path in bf16 against
   it in fp32; by max, the MoE models by their bulk: a route flip moves a
   token by a whole expert), fp32 compute to 1e-4; the profile of 5; then a
   control, the kernel path with its weights at 5 bits, must exceed that
   limit;
19. train phases, one function for every config: gemma-2b, qwen3-8b and the
   four above at full width and the deepest depth whose step, extrapolated
   from one-step probes at the shallowest cut with every kind of block
   (deepseek: its dense layer and one MoE layer) and one layer more, leaves
   10% of the card (the second probe only where the first's peak scaled by
   the parameters fits the card), train 6 AsyncSAM AdamW steps through
   `FusedExecutor` + `Engine`: each epilogue kernel once a step, flash on
   every forward as the model implies; moe_aux finite, and non-zero exactly
   on the MoE models; one step profiled; the lockstep check of one step at
   half that depth;
20. variants phase: full-width olmo-1b at 4 of its 16 layers trains gsam (3 steps,
   bucket-resident), looksam (k 2: fresh, reuse, fresh, reuse), esam (3),
   aesam (10: 8 forced SAM steps, then its z decides) and mesa (4, the term
   on from step 2) on per-leaf state, as the launcher builds them; every
   step's launches of sq_norm, sam_perturb, fused_axpy, fused_dot_norms,
   adamw_epilogue and flash held to its branch's; step time, peak memory,
   the state each carries, one step profiled (its copies and host reads:
   AE-SAM's z); every weight-space kernel call of one gsam step and of a
   looksam fresh and reuse step against its plain version;
21. MoE whole-path check: deepseek-v2-lite at 2 layers (its dense layer and
   one MoE layer), batch 2 x 512: one forward on the kernel path and on the
   plain path in bf16, the (token, slot) routes that differ counted, the
   logits held by their bulk to twice bf16's own error (a 6-bit-weights
   control must exceed it); then the whole training path against the
   plain path as the scan families' (`scan_whole_check`);
22. prints the wall seconds of every phase as it ends ("X phase: Ns") and,
   at the end, of every phase and of the parts of it that take time
   (`spans {...}`: nested phases joined by "/"), the whole run's, the
   kernels' JSON line and, last, {"ok": true, "device": {...}}.

Any failure raises and exits nonzero before the last line. Without CUDA, or
without the repository beside it, it exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
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


# wall seconds of each span of the run, by its path of nested span names;
# printed in full before the kernels' line
SPANS: dict = {}
_SPAN_PATH: list = []


@contextlib.contextmanager
def span(name: str):
    """Adds the wall time of the block to SPANS under the enclosing spans'
    names and `name`, joined by "/"."""
    _SPAN_PATH.append(name)
    key, t0 = "/".join(_SPAN_PATH), time.perf_counter()
    try:
        yield
    finally:
        SPANS[key] = SPANS.get(key, 0.0) + time.perf_counter() - t0
        _SPAN_PATH.pop()


@contextlib.contextmanager
def phase(name: str):
    """A span that prints its seconds on exit as "`name` phase: Xs"."""
    key = "/".join(_SPAN_PATH + [name])
    with span(name):
        yield
    print(f"{name} phase: {SPANS[key]:.2f}s")


def spanned(fn):
    """`fn` with each call's time added to its own span, named after it."""
    import functools

    @functools.wraps(fn)
    def call(*args, **kwargs):
        with span(fn.__name__):
            return fn(*args, **kwargs)
    return call


def nvidia_smi() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


@spanned
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


@spanned
def result_and_ms(fn):
    """(fn(), the device time of one more call by CUDA events, the first
    having warmed it, as `time_ms(fn, 0.0)` times it): a plain version whose
    result is the oracle too (they take 0.1-3 s a call: `time_ms`'s own
    warm-up call would cost the run seconds)."""
    import torch
    out = fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


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
    ("deepseek-v2-lite MLA prefill", (8, 1024, 1024, 16, 16, 192, 128), "bfloat16", True,
     None, 0, "wgmma"),
    ("mixtral-8x7b prefill, window 4096", (2, 8192, 8192, 32, 8, 128, 128), "bfloat16",
     True, 4096, 0, "wgmma"),
    ("phi-3-vision prefill (hd 96)", (8, 1024, 1024, 32, 32, 96, 96), "bfloat16", True,
     None, 0, "wgmma"),
    ("whisper-tiny encoder / cross", (8, 1024, 1024, 6, 6, 64, 64), "bfloat16", False,
     None, 0, "wgmma"),
    ("whisper-tiny decoder self", (8, 1024, 1024, 6, 6, 64, 64), "bfloat16", True, None, 0,
     "wgmma"),
    ("bf16 hd 40", (2, 256, 256, 4, 2, 40, 40), "bfloat16", True, None, 0, "cuda_cores"),
    ("fp32", (2, 256, 256, 4, 2, 64, 64), "float32", True, None, 0, "cuda_cores"),
    # the heads one rank computes under the tensor-parallel layout (the
    # attention sharded on heads over "model", `models.layers`)
    ("olmo-1b prefill, 8 local heads (model 2)", (8, 1024, 1024, 8, 8, 128, 128),
     "bfloat16", True, None, 0, "wgmma"),
    ("olmo-1b prefill, 1 local head (model 16)", (8, 1024, 1024, 1, 1, 128, 128),
     "bfloat16", True, None, 0, "wgmma"),
    ("qwen3-8b prefill, 8/2 local heads (model 4)", (8, 1024, 1024, 8, 2, 128, 128),
     "bfloat16", True, None, 0, "wgmma"),
    # MLA on its heads (1 of deepseek's 16 a rank) and mixtral's 2 of 32
    # query heads a rank on the one kv head they share (8 on 16 do not split)
    ("deepseek-v2-lite MLA prefill, 1 local head (model 16)",
     (8, 1024, 1024, 1, 1, 192, 128), "bfloat16", True, None, 0, "wgmma"),
    ("mixtral-8x7b prefill, window 4096, 2/1 local heads (model 16)",
     (2, 8192, 8192, 2, 1, 128, 128), "bfloat16", True, 4096, 0, "wgmma"),
]
# each local-head case beside the full-head case of its model
LOCAL_HEAD_CASES = {"olmo-1b prefill, 8 local heads (model 2)": "olmo-1b prefill",
                    "olmo-1b prefill, 1 local head (model 16)": "olmo-1b prefill",
                    "qwen3-8b prefill, 8/2 local heads (model 4)": "qwen3-8b prefill",
                    "deepseek-v2-lite MLA prefill, 1 local head (model 16)":
                        "deepseek-v2-lite MLA prefill",
                    "mixtral-8x7b prefill, window 4096, 2/1 local heads (model 16)":
                        "mixtral-8x7b prefill, window 4096"}


def visible_pairs(sq: int, sk: int, causal: bool, window, q_offset: int = 0) -> int:
    """(query, key) pairs the mask lets through: the work this input needs
    (the kernel module's count, which its flop formula uses too)."""
    from repro_torch.kernels import flash_attention as fa
    return fa.visible_pairs(sq, sk, causal, window, q_offset)


def flash_bound(shape, dtype: str, causal: bool, window, q_offset: int = 0
                ) -> tuple[float, str]:
    b, sq, sk, h, kv, hd, hd_v = shape
    elem = 2 if dtype == "bfloat16" else 4
    # k and v are read only for the keys some row sees: up to the last row's
    # position under causal, from the first row's window start
    hi = min(sk, q_offset + sq) if causal else sk
    lo = max(0, q_offset - window + 1) if window else 0
    keys = max(0, hi - lo)
    nbytes = elem * (b * sq * h * hd + b * keys * kv * (hd + hd_v) + b * sq * h * hd_v)
    flops = 2 * (hd + hd_v) * b * h * visible_pairs(sq, sk, causal, window, q_offset)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_call(q, k, v, causal: bool, window, q_offset: int = 0):
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    if window is None and not q_offset:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                      enable_gqa=gqa)
    window = window or k.shape[1] + q_offset + q.shape[1]
    qpos = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
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

    main_case, failures, rows = None, [], {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, shape, dtype, causal, window, offset, want_path in FLASH_CASES:
        b, sq, sk, h, kv, hd, hd_v = shape
        tdt = getattr(torch, dtype)
        q, k, v = (torch.randn((*s[:-1], s[-1] + offset), generator=gen,
                               device="cuda").to(tdt)[..., offset:]
                   for s in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd_v)))
        before = fa.launches
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        launches = fa.launches - before
        expect = ref.flash_attention_plain(q, k, v, causal=causal, window=window)
        tol = BF16_TOL if dtype == "bfloat16" else FP32_TOL
        diff = (out.float() - expect.float()).abs()
        err = float(diff.max())
        path = fa.kernel_path(q, k, v)
        ok = (out.shape == expect.shape and bool(torch.isfinite(out).all())
              and bool((diff <= tol["atol"] + tol["rtol"] * expect.float().abs()).all())
              and path == want_path and launches == 1)
        ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal, window=window))
        plain_ms = time_ms(lambda: ref.flash_attention_plain(q, k, v, causal=causal,
                                                             window=window))
        library_ms = time_ms(sdpa_call(q, k, v, causal, window))
        bound_ms, bound_by = flash_bound(shape, dtype, causal, window)
        row = dict(case=name, shape=shape, dtype=dtype, causal=causal, window=window,
                   path=path, want_path=want_path, launches=launches, max_abs_err=err,
                   atol=tol["atol"],
                   rtol=tol["rtol"], ok=ok, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        full = rows.get(LOCAL_HEAD_CASES.get(name))
        if full is not None:
            row.update(full_case=full["case"], full_ms=full["ms"],
                       full_over_local=full["ms"] / ms)
        rows[name] = row
        print("flash_attention " + json.dumps(row))
        if not ok:
            failures.append(name)
        if main_case is None:
            main_case = row
    if failures:
        fail(f"flash_attention kernel disagrees with its plain version or takes another "
             f"path than its case's: {failures}")
    return main_case


# The flash kernel with a query offset at the rank shapes of the "fsdp_sp"
# profile on a 16-way "model" axis (`models.layers`: a rank's block of the
# queries against the whole sequence's k and v, gathered over "model"): the
# rows of a microbatch of 4 (train_4k's 16 rows a dp rank in 4 microbatches)
# or of prefill_32k's one row a rank on 2x16x16. (name, (B, Sq, Sk, H, K,
# hd, hd_v), q_offset[, causal (default True)[, window]]); bf16, the wgmma
# path.
OFFSET_CASES = [
    ("qwen2.5-32b train_4k, rank 0 of 16", (4, 256, 4096, 40, 8, 128, 128), 0),
    ("qwen2.5-32b train_4k, rank 7 of 16", (4, 256, 4096, 40, 8, 128, 128), 1792),
    ("qwen2.5-32b train_4k, rank 15 of 16", (4, 256, 4096, 40, 8, 128, 128), 3840),
    ("qwen2.5-32b prefill_32k, rank 15 of 16", (1, 2048, 32768, 40, 8, 128, 128), 30720),
    ("zamba2-1.2b shared attention train_4k, rank 15 of 16", (4, 256, 4096, 32, 32, 64, 64),
     3840),
    # the other families the "fsdp_sp" profile reaches: deepseek's MLA
    # (k and v decompressed from the latents, hd 192 / hd_v 128), mixtral's
    # 4096-token window on prefill_32k's last block, phi-3-vision's hd 96,
    # and whisper-tiny's non-causal encoder block (its decoder's
    # cross-attention is the same call over the encoder's frames)
    ("deepseek-v2-lite MLA train_4k, rank 15 of 16", (4, 256, 4096, 16, 16, 192, 128), 3840),
    ("mixtral-8x7b prefill_32k, window 4096, rank 15 of 16",
     (1, 2048, 32768, 32, 8, 128, 128), 30720, True, 4096),
    ("phi-3-vision train_4k, rank 15 of 16", (4, 256, 4096, 32, 32, 96, 96), 3840),
    ("whisper-tiny encoder train_4k, non-causal, rank 15 of 16", (4, 256, 4096, 6, 6, 64, 64),
     3840, False),
]


def offset_flash_phase() -> list:
    """Each OFFSET_CASES entry against the plain version with the same
    offset, its launch counted, timed beside its bound and SDPA with the
    equivalent boolean mask; fails when a case disagrees, does not launch
    the kernel or leaves the wgmma path. Returns the rows."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    rows, failures = [], []
    gen = torch.Generator(device="cuda").manual_seed(1)
    for name, shape, q_off, *mask in OFFSET_CASES:
        causal, window = (mask + [True, None][len(mask):])
        b, sq, sk, h, kv, hd, hd_v = shape
        q, k, v = (torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
                   for s in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd_v)))
        before = fa.launches
        out = fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_off)
        torch.cuda.synchronize()
        launches = fa.launches - before
        expect = ref.flash_attention_plain(q, k, v, causal=causal, window=window,
                                           q_offset=q_off)
        diff = (out.float() - expect.float()).abs()
        err, path = float(diff.max()), fa.kernel_path(q, k, v)
        ok = (out.shape == expect.shape and bool(torch.isfinite(out).all()) and launches == 1
              and bool((diff <= BF16_TOL["atol"] + BF16_TOL["rtol"]
                        * expect.float().abs()).all()) and path == "wgmma")
        del out, expect, diff
        ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal, window=window,
                                                q_offset=q_off))
        plain_ms = time_ms(lambda: ref.flash_attention_plain(q, k, v, causal=causal,
                                                             window=window, q_offset=q_off), 0.0)
        library_ms = time_ms(sdpa_call(q, k, v, causal, window, q_off))
        bound_ms, bound_by = flash_bound(shape, "bfloat16", causal, window, q_off)
        row = dict(case=name, shape=shape, q_offset=q_off, causal=causal, window=window,
                   pairs=visible_pairs(sq, sk, causal, window, q_off), path=path,
                   launches=launches, max_abs_err=err, atol=BF16_TOL["atol"], rtol=BF16_TOL["rtol"], ok=ok, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        print("flash_attention offset " + json.dumps(row))
        rows.append(row)
        if not ok:
            failures.append(name)
        del q, k, v
        torch.cuda.empty_cache()
    if failures:
        fail(f"flash_attention with a query offset disagrees with its plain version, "
             f"did not launch or left the wgmma path: {failures}")
    return rows


# ---------------------------------------------------------------------------
# the moe family's layout under "tp": expert shares and decode over blocks
# ---------------------------------------------------------------------------

# One full-width MoE layer of each moe arch cut into the shares its ranks
# compute on a 16-way "model" axis (`models.moe.moe_share`): deepseek in 16
# EP shares of 4 of its 64 experts (its 2 shared experts in 16 shares of
# their 2816 columns), mixtral in 16 expert-TP shares of 896 of its 14336
# columns. (arch, m); x of SHARE_TOKENS, bf16 compute.
SHARE_CASES = (("deepseek-v2-lite-16b", 16), ("mixtral-8x7b", 16))
SHARE_TOKENS = (8, 1024)


def held(got, want, tol: dict) -> tuple[bool, float, float]:
    """(got finite and every element within atol + rtol max |want|, max
    |got - want|, that over max |want|): the tolerance of the tensor's
    scale, since a gradient summed over every token (the router's) rounds
    each partial sum in bf16 on both sides."""
    import torch
    diff = (got.float() - want.float()).abs()
    scale = want.float().abs().max()
    ok = bool(torch.isfinite(got).all()) and bool(
        (diff <= tol["atol"] + tol["rtol"] * scale).all())
    return ok, float(diff.max()), float(diff.max() / scale.clamp_min(1e-30))


def ring(parts):
    """The parts added one after another in their dtype, as a ring's hops
    add them."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def expert_share_phase() -> list:
    """Each SHARE_CASES layer (fp32 weights from seed 0 at the models' init
    scale, std 1/sqrt(fan-in); bf16 compute) on x of SHARE_TOKENS: the m
    shares computed one after another through `moe_share`, each on
    `moe.expert_share` of the whole weights and its own bf16 copy of x, from
    one routing, summed with the shared experts' shares and one aux, held
    against the whole `moe_apply` within BF16_TOL of its max (`held`), and
    so are the gradients of x, the router and we_in (a loss of y against
    fixed random weights plus the aux); the routing is one, so no route
    differs. A rank's forward (the routing, its share of the experts and of
    the shared experts) timed beside the whole layer's. Fails on a
    disagreement."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe as MOE

    rows = []
    for arch, m in SHARE_CASES:
        cfg = get_config(arch)
        gen = torch.Generator(device="cuda").manual_seed(0)

        def init(shapes):
            return {k: (torch.randn(sh, generator=gen, device="cuda") * sh[-2] ** -0.5
                        ).requires_grad_() for k, sh in shapes.items()}

        params = init(MOE.moe_shapes(cfg))
        if cfg.moe.n_shared_experts:
            params["shared"] = init(MOE.shared_shapes(cfg))
        x32 = torch.randn(*SHARE_TOKENS, cfg.d_model, generator=gen, device="cuda"
                          ).to(torch.bfloat16).float().requires_grad_()
        w = torch.randn(*SHARE_TOKENS, cfg.d_model, generator=gen, device="cuda")
        dt = getattr(torch, cfg.compute_dtype)
        leaves = [x32, params["router"], params["we_in"]]

        y, aux = MOE.moe_apply(params, x32.to(dt), cfg)
        want = torch.autograd.grad((y.float() * w).sum() + aux, leaves)
        y = y.detach()
        rt = MOE.make_routing(params["router"], x32.to(dt), cfg)
        total = torch.zeros(y.shape, dtype=torch.float32, device="cuda")
        for r in range(m):
            share = MOE.expert_share(params, cfg, r, m)
            xr = x32.to(dt)
            total = total + MOE.moe_share(share, xr, cfg, r, m, routing=rt).float()
            if "shared" in share:
                total = total + MOE.shared_apply(share["shared"], xr, cfg).float()
        aux_s = MOE.aux_loss(rt, cfg)
        got = torch.autograd.grad((total * w).sum() + aux_s, leaves)
        total, aux, aux_s = total.detach(), aux.detach(), aux_s.detach()
        checks = {"y": held(total, y, BF16_TOL)}
        for name, g, g_want in zip(("x_grad", "router_grad", "we_in_grad"), got, want):
            checks[name] = held(g, g_want, BF16_TOL)
        del got, want
        with torch.no_grad():
            xb = x32.detach().to(dt)
            share0 = MOE.expert_share(params, cfg, 0, m)

            def one_share():
                out = MOE.moe_share(share0, xb, cfg, 0, m)
                if "shared" in share0:
                    out = out + MOE.shared_apply(share0["shared"], xb, cfg)
                return out

            whole_ms = time_ms(lambda: MOE.moe_apply(params, xb, cfg))
            share_ms = time_ms(one_share)
        e_loc = share0["we_in"].shape[0]
        row = dict(case=f"{arch} MoE layer, {m} shares", layout="EP" if e_loc != cfg.moe.n_experts
                   else "expert TP", we_in_share=tuple(share0["we_in"].shape),
                   we_out_share=tuple(share0["we_out"].shape), tokens=SHARE_TOKENS,
                   aux=float(aux.detach()), aux_shares=float(aux_s.detach()), route_flips=0,
                   **{f"{k}_max_abs_err": v[1] for k, v in checks.items()},
                   **{f"{k}_err_over_max": v[2] for k, v in checks.items()},
                   atol=BF16_TOL["atol"], rtol=BF16_TOL["rtol"],
                   ok=all(v[0] for v in checks.values()) and float(aux) == float(aux_s),
                   whole_ms=whole_ms, share_ms=share_ms, whole_over_share=whole_ms / share_ms)
        print("moe shares " + json.dumps(row))
        rows.append(row)
        del params, x32, w, y, total, share0, leaves
        torch.cuda.empty_cache()
        if not row["ok"]:
            fail(f"{arch}: the sum of the {m} expert shares disagrees with the whole layer")
    return rows


# One full-width mixtral-8x7b MoE layer on MOE_BLOCKS sequence blocks of
# MOE_BLOCK_TOKENS, as the "fsdp_sp" profile's ranks compute it
# (`models.moe`): each block routed on its own rows, each route ranked
# after the row's earlier blocks' routes to its expert (`moe.routing_of`,
# as `make_routing` calls it, over every block's `moe.expert_counts`),
# its block's buffer at the whole row's capacity (`moe_share` in the
# block's layout: no collective runs there, so a layout without groups
# stands for the rank's), the aux from every block's `moe.aux_shares`
# summed (`aux_loss`'s group_sum); fp32 weights from seed 4, bf16
# compute, the config's capacity factor 1.25, x skewed so that the whole
# row drops routes.
MOE_BLOCKS, MOE_BLOCK_TOKENS = 16, (2, 4096)


def moe_block_phase() -> dict:
    """The MOE_BLOCKS blocks' routes, their ranks and outputs against the
    whole layer's (`moe_apply`, `make_routing`): the (token, slot) routes
    that differ (route_flips) and the ranks that differ must be 0, the
    dropped routes the same, y within BF16_TOL of its max (`held`) and the
    aux from the blocks' summed counts and probabilities within FP32_TOL of
    the whole's; one block's forward timed beside the whole layer's. Fails
    on a disagreement."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe as MOE
    from repro_torch.models import partitioning

    cfg = get_config("mixtral-8x7b")
    E, C = cfg.moe.n_experts, MOE._capacity(cfg.moe, MOE_BLOCK_TOKENS[1])
    gen = torch.Generator(device="cuda").manual_seed(4)
    params = {k: torch.randn(sh, generator=gen, device="cuda") * sh[-2] ** -0.5
              for k, sh in MOE.moe_shapes(cfg).items()}
    dt = getattr(torch, cfg.compute_dtype)
    # a direction every token shares skews the routing to a few experts
    common = torch.randn(cfg.d_model, generator=gen, device="cuda")
    xb = (torch.randn(*MOE_BLOCK_TOKENS, cfg.d_model, generator=gen, device="cuda")
          + common).to(dt)
    b, s = MOE_BLOCK_TOKENS
    w = s // MOE_BLOCKS
    blocks = [xb[:, r * w:(r + 1) * w].contiguous() for r in range(MOE_BLOCKS)]

    def block_routes(r, counts):
        """Block r's routing as `make_routing` computes it on rank r, every
        block's `expert_counts` stacked here in place of its all-gather."""
        return MOE.routing_of(*MOE.route(params["router"], blocks[r], cfg), cfg, s, counts, r)

    def block_share(r, rt):
        """Block r's share (the whole experts), in its rank's layout."""
        lay = partitioning.Layout(None, None, MOE_BLOCKS, r, None, seq=(r * w, (r + 1) * w))
        with partitioning.layout_context(lay):
            return MOE.moe_share(params, blocks[r], cfg, routing=rt)

    with torch.inference_mode():
        y_w, aux_w = MOE.moe_apply(params, xb, cfg)
        rt_w = MOE.make_routing(params["router"], xb, cfg)
        counts = torch.stack([MOE.expert_counts(MOE.route(params["router"], xr, cfg)[2], E)
                              for xr in blocks])
        routes = [block_routes(r, counts) for r in range(MOE_BLOCKS)]
        y = torch.cat([block_share(r, rt) for r, rt in enumerate(routes)], dim=1)
        gate_idx = torch.cat([rt.gate_idx for rt in routes], dim=1)
        rank = torch.cat([rt.rank for rt in routes], dim=1)
        flips = int((gate_idx != rt_w.gate_idx).sum())
        moved = int((rank != rt_w.rank).sum())
        dropped, dropped_w = int((rank >= C).sum()), int((rt_w.rank >= C).sum())
        # `aux_loss` under a block: every block's shares, summed (group_sum)
        shares = [MOE.aux_shares(rt, b * s) for rt in routes]
        aux = MOE.aux_value(sum(f for f, _ in shares), sum(p for _, p in shares), cfg)
        ok_y, err, rel = held(y, y_w, BF16_TOL)
        aux_rel = abs(float(aux) - float(aux_w)) / abs(float(aux_w))

        def one_block():
            block_share(MOE_BLOCKS - 1, block_routes(MOE_BLOCKS - 1, counts))

        whole_ms = time_ms(lambda: MOE.moe_apply(params, xb, cfg))
        block_ms = time_ms(one_block)
    ok = (ok_y and flips == 0 and moved == 0 and dropped == dropped_w > 0
          and aux_rel <= FP32_TOL["rtol"])
    row = dict(case=f"mixtral-8x7b MoE layer, {MOE_BLOCKS} sequence blocks",
               tokens=MOE_BLOCK_TOKENS, block_tokens=(b, w), capacity=C, route_flips=flips,
               ranks_moved=moved, dropped=dropped, dropped_whole=dropped_w, y_max_abs_err=err,
               y_err_over_max=rel, aux=float(aux), aux_whole=float(aux_w), aux_rel_err=aux_rel,
               atol=BF16_TOL["atol"], rtol=BF16_TOL["rtol"], ok=ok, whole_ms=whole_ms,
               block_ms=block_ms, whole_over_block=whole_ms / block_ms)
    print("moe blocks " + json.dumps(row))
    del params, xb, blocks, y_w, y, routes, rt_w
    torch.cuda.empty_cache()
    if not ok:
        fail("mixtral's MoE layer on sequence blocks disagrees with the whole layer "
             f"(route flips {flips}, ranks moved {moved}, y ok {ok_y}, aux {aux_rel})")
    return row


# Decode over a cache in 16 sequence blocks, as the "tp" serve step's ranks
# hold it where the kv heads cannot carry it: mixtral's GQA (32 query heads
# on 8 kv heads, window 4096), deepseek's absorbed MLA (16 heads over a
# 512 + 64 latent) and whisper-tiny's cross-attention (6 heads, which 16
# does not divide, over decode_32k's 32,768 encoder positions, every one
# valid), each block's part computed on one card and the parts merged by
# `distributed.lse_merge`, the combine `lse_combine` does across ranks.
# (name, batch, cache length, valid length); fp32.
BLOCK_DECODE_CASES = (("mixtral-8x7b GQA, window 4096", 4, 65536, 40000),
                      ("deepseek-v2-lite absorbed MLA", 4, 65536, 40000),
                      ("whisper-tiny cross-attention", 8, 32768, 32768))
DECODE_BLOCKS = 16


def block_decode_phase() -> list:
    """Each BLOCK_DECODE_CASES decode (one new position, fp32, seed 1)
    computed as DECODE_BLOCKS parts (`layers.decode_attention_part` with the
    window, or each block valid to its end as `layers.decode_blocks` takes
    the cross k/v; `mla.absorbed_decode_part`) merged by
    `distributed.lse_merge`, held against the whole decode
    (`ref.decode_attention_plain`; MLA's whole-cache absorbed decode as
    `mla_apply` computes it; the encoder-decoder's cross decode,
    `ops.decode_attention` over every position) within FP32_TOL of its max;
    mixtral's window leaves all but two blocks with no visible key, which
    must come out with l = o = 0. The parts and merge timed beside the
    whole. Fails on a disagreement."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    from repro_torch.models import mla as MLA
    from repro_torch.utils import distributed

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for name, b, n, valid in BLOCK_DECODE_CASES:
        w = n // DECODE_BLOCKS
        if name.startswith("mixtral"):
            cfg = get_config("mixtral-8x7b")
            hd = cfg.resolved_head_dim
            q = torch.randn(b, 1, cfg.n_heads, hd, generator=gen, device="cuda")
            k, v = (torch.randn(b, n, cfg.n_kv_heads, hd, generator=gen, device="cuda")
                    for _ in range(2))

            def parts():
                return [L.decode_attention_part(q, k[:, i:i + w], v[:, i:i + w], valid, i,
                                                window=cfg.sliding_window)
                        for i in range(0, n, w)]

            def merged():
                out = distributed.lse_merge(*(torch.stack(t) for t in zip(*parts())))
                return out.permute(0, 3, 1, 2, 4).reshape(b, 1, cfg.n_heads, hd)

            def whole():
                return ref.decode_attention_plain(q, k, v, valid, window=cfg.sliding_window)
        elif name.startswith("whisper"):
            from repro_torch.kernels import ops
            cfg = get_config("whisper-tiny")
            hd = cfg.resolved_head_dim
            q = torch.randn(b, 1, cfg.n_heads, hd, generator=gen, device="cuda")
            k, v = (torch.randn(b, n, cfg.n_kv_heads, hd, generator=gen, device="cuda")
                    for _ in range(2))

            def parts():
                return [L.decode_attention_part(q, k[:, i:i + w], v[:, i:i + w], i + w, i)
                        for i in range(0, n, w)]

            def merged():
                out = distributed.lse_merge(*(torch.stack(t) for t in zip(*parts())))
                return out.permute(0, 3, 1, 2, 4).reshape(b, 1, cfg.n_heads, hd)

            def whole():
                return ops.decode_attention(q, k, v, n)
        else:
            cfg = get_config("deepseek-v2-lite-16b")
            mc = cfg.mla
            q_lat = torch.randn(b, 1, cfg.n_heads, mc.kv_lora_rank, generator=gen, device="cuda")
            q_rope = torch.randn(b, 1, cfg.n_heads, mc.qk_rope_head_dim, generator=gen,
                                 device="cuda")
            c_kv = torch.randn(b, n, mc.kv_lora_rank, generator=gen, device="cuda")
            k_rope = torch.randn(b, n, mc.qk_rope_head_dim, generator=gen, device="cuda")

            def parts():
                return [MLA.absorbed_decode_part(q_lat, q_rope, c_kv[:, i:i + w],
                                                 k_rope[:, i:i + w], valid, i, cfg)
                        for i in range(0, n, w)]

            def merged():
                return distributed.lse_merge(*(torch.stack(t) for t in zip(*parts())))

            def whole():
                # mla_apply's whole-cache absorbed decode: o_lat (B, H, T, R)
                scores = (torch.einsum("bthr,bsr->bhts", q_lat, c_kv)
                          + torch.einsum("bthn,bsn->bhts", q_rope, k_rope))
                scores = scores / math.sqrt(mc.qk_nope_head_dim + mc.qk_rope_head_dim)
                scores = torch.where(torch.arange(n, device="cuda") < valid, scores, -1e30)
                return torch.einsum("bhts,bsr->bhtr", torch.softmax(scores, dim=-1), c_kv)

        with torch.no_grad():
            empty = sum(int(not bool(l.any()) and not bool(o.any())) for _, l, o in parts())
            got, want = merged(), whole()
            ok, err, rel = held(got, want, FP32_TOL)
            merged_ms, whole_ms = time_ms(merged), time_ms(whole)
        row = dict(case=name, batch=b, cache=n, blocks=DECODE_BLOCKS, valid=valid,
                   blocks_without_keys=empty, max_abs_err=err, err_over_max=rel,
                   atol=FP32_TOL["atol"],
                   rtol=FP32_TOL["rtol"], ok=ok, merged_ms=merged_ms, whole_ms=whole_ms)
        print("block decode " + json.dumps(row))
        rows.append(row)
        torch.cuda.empty_cache()
        if not ok:
            fail(f"{name}: the merged block parts disagree with the whole decode")
    if rows[2]["blocks_without_keys"]:
        fail("every block of whisper's cross k/v holds valid keys, "
             f"not {DECODE_BLOCKS - rows[2]['blocks_without_keys']} of {DECODE_BLOCKS}")
    want_empty = DECODE_BLOCKS - 2
    if rows[0]["blocks_without_keys"] != want_empty:
        fail(f"mixtral's window should leave {want_empty} blocks without a key, "
             f"not {rows[0]['blocks_without_keys']}")
    return rows


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


@spanned
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

    with span("plain prefills"):
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


@spanned
def profile_phase(model, cfg=None, n_req: int = 8, prompt_len: int = 1024,
                  tag: str = "", compare_readings: bool = False) -> dict:
    """Device time by kernel over one full-width prefill of n_req x
    prompt_len prompts (with the launcher's stub inputs) and 4 decode steps
    (torch.profiler), and the device's busy share of the wall time. With
    `compare_readings` the prefill's kernels are also read from the event
    tree (`event_tree_by_kernel`) and the two readings printed side by
    side, with the names only one of them has. Returns {phase: {wall_us,
    busy_us, busy}}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.synthetic import TokenTask
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import build_model

    cfg = cfg or model.cfg
    bundle = build_model(cfg)
    batch = prompt_batch(cfg, torch.as_tensor(
        TokenTask(cfg.vocab_size, seed=0).sample(n_req, prompt_len), device="cuda"))
    pad_to = prompt_len + 36
    out = {}
    for phase in ("prefill", "decode"):
        with torch.inference_mode():
            logits, cache = bundle.prefill(model, batch, pad_to=pad_to)
            tok = logits[:, -1].argmax(-1)[:, None]
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if phase == "prefill":
                    bundle.prefill(model, batch, pad_to=pad_to)
                else:
                    for _ in range(4):
                        logits, cache = bundle.decode(model, cache, {"tokens": tok})
                        tok = logits[:, -1].argmax(-1)[:, None]
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
        by_name = device_time_by_kernel(prof)
        busy_us = sum(t for t, _ in by_name.values())
        out[phase] = dict(wall_us=wall_us, busy_us=busy_us, busy=busy_us / wall_us)
        print(f"profile {tag + ' ' if tag else ''}{phase}: wall {wall_us:.1f} us, device "
              f"kernels {busy_us:.1f} us (busy {100 * busy_us / wall_us:.1f}%), "
              f"{len(by_name)} kernel names")
        for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
            print(f"  {t:12.1f} us {100 * t / busy_us:5.1f}%  {n:5d}x  {name[:110]}")
        if compare_readings and phase == "prefill":
            tree = event_tree_by_kernel(prof)

            def only(a, b):
                return {k[:110]: a[k] for k in sorted(set(a) - set(b))}

            calls = (sum(n for _, n in by_name.values()), sum(n for _, n in tree.values()))
            print(f"profile {tag + ' ' if tag else ''}prefill, raw events against the event "
                  f"tree: {len(by_name)} / {len(tree)} kernel names, {busy_us:.1f} / "
                  f"{sum(t for t, _ in tree.values()):.1f} us, {calls[0]} / {calls[1]} "
                  f"kernels; in the raw events only "
                  f"{json.dumps(only(by_name, tree))}; in the tree only "
                  f"{json.dumps(only(tree, by_name))}; every name, by device time: "
                  f"{json.dumps([k[:80] for k in sorted(by_name, key=lambda k: -by_name[k][0])])}")
    return out


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


def flash_calls_per_forward(cfg) -> int:
    """Flash calls of one forward: one a layer; whisper's encoder layers,
    and its decoder's self- and cross-attention a layer."""
    if cfg.family == "audio":
        return cfg.encdec.n_encoder_layers + 2 * cfg.n_layers
    return cfg.n_layers


def flash_per_step(cfg) -> tuple[int, str]:
    """Flash launches one AsyncSAM step implies: 2 gradient passes (ascent at
    w, descent at w_hat); each runs every block's forward once, and again in
    backward when the block is checkpointed (remat "full" or "dots")."""
    fwd = 1 if cfg.remat == "none" else 2
    calls = flash_calls_per_forward(cfg)
    n = 2 * fwd * calls
    return n, (f"2 gradient passes x {fwd} forward(s) per block (remat={cfg.remat!r}) x "
               f"{calls} calls a forward = {n}")


def train_executor(steps: int, lr: float = LR, family: str = "adamw", cfg=None,
                   method: str = "async_sam", mkw=None, loss_wrap=None, mesh=None):
    """(cfg, bundle, executor) of `build_trainer`: olmo-1b (full width and
    depth unless `cfg`), AsyncSAM (or `method`, with the MethodConfig fields
    `mkw`) with AdamW (what `python -m repro_torch.launch.train` builds) or
    with the paper's sgd(momentum 0.9). `loss_wrap(loss_fn)` replaces the
    model's loss; `mesh` (a `launch.mesh.Mesh`) goes to the executor with the
    config, as the launcher's fused executor gets its host mesh."""
    from repro_torch.configs import get_config
    from repro_torch.core import MethodConfig
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
                       opt, mesh=mesh, model_cfg=cfg if mesh is not None else None)
    return cfg, bundle, ex


@spanned
def build_trainer(steps: int, lr: float = LR, family: str = "adamw", cfg=None,
                  method: str = "async_sam", batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                  mkw=None, loss_wrap=None, mesh=None):
    """`train_executor`'s executor on the card with its state from seed 0,
    and its pipeline (an ascent sub-batch for async_sam only, as the
    launcher's)."""
    from repro_torch.data import PipelineConfig, TokenPipeline

    cfg, bundle, ex = train_executor(steps, lr, family, cfg, method, mkw, loss_wrap, mesh)
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
               loss_last=rows[-1]["loss"])
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


def check_run(lr: float, plain=False, w0=None, coarse_bits: int = 0, **trainer):
    """3 steps from the seed-0 init (olmo-1b unless `trainer` names another
    cfg, batch or seq for `build_trainer`; with `coarse_bits` its weights
    rounded to that many significant bits), every entry point forced to its
    plain version when `plain`. Returns (metrics history, final {w, mu, nu}
    buffers, the init w), all on the card; the executor's workspace is
    freed."""
    import gc
    import torch
    from repro_torch.engine import Engine
    from repro_torch.kernels import ops

    if plain:
        ops.set_default_impl("plain")
    try:
        with span("build"):
            cfg, ex, state, pipe = build_trainer(TRAIN_CHECK_STEPS, lr, **trainer)
            if w0 is None:
                w0 = state.params.buffers[0].clone()
            if coarse_bits:
                for buf in state.params.buffers:
                    coarsen_(buf, coarse_bits)
        with span("fit"):
            report = Engine(ex, pipe).fit(state, TRAIN_CHECK_STEPS)
    finally:
        ops.set_default_impl(None)
    final = report.final_state
    adam = final.opt_state[0]                          # (AdamState, (), lr state)
    bufs = {"w": final.params.buffers[0], "mu": adam.mu.buffers[0], "nu": adam.nu.buffers[0]}
    hist = report.metrics_history
    del ex, state, pipe, report, final, adam
    gc.collect()
    torch.cuda.empty_cache()
    return hist, bufs, w0


@spanned
def compare_runs(ref_run, run, w0) -> dict:
    """Per-step scalar differences and, per buffer, max|d|, max|change| and
    their ratio, and the BULK_QUANTILES of |d| and of |change| (over every
    BULK_STRIDE-th element); change is the reference run's own move from the
    init, for mu and nu their value."""
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
            r = bufs_r[name][i:i + COMPARE_CHUNK]
            d = (bufs[name][i:i + COMPARE_CHUNK] - r).abs()
            c = (r - w0[i:i + COMPARE_CHUNK]).abs() if name == "w" else r.abs()
            err, change = max(err, float(d.max())), max(change, float(c.max()))
            d_s.append(d[(-i) % BULK_STRIDE::BULK_STRIDE])
            c_s.append(c[(-i) % BULK_STRIDE::BULK_STRIDE])
        out[name] = {"max_abs": err, "max_change": change, "max_rel": err / change,
                     "q_abs": torch.quantile(torch.cat(d_s), q).tolist(),
                     "q_change": torch.quantile(torch.cat(c_s), q).tolist()}
    return out


@spanned
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
    with span("lockstep"):
        lock = lockstep_check()
    ok_lock = all(r["calls"] == r["launches"] == TRAIN_CHECK_STEPS
                  and r["max_rel_err"] <= LOCKSTEP_REL_TOL for r in lock.values())
    print(f"train check, lockstep ({TRAIN_CHECK_STEPS} steps, lr {LR}; each epilogue kernel "
          f"call on the path vs its plain version on the same inputs): {json.dumps(lock)}; "
          f"tolerance: rel {LOCKSTEP_REL_TOL}, one call and one launch per step each")

    # the plain path first, on the whole card; its buffers stay there beside
    # the kernel path's run
    hist, bufs, w0 = check_run(WHOLE_CHECK_LR, True)
    kern_hist, kern_bufs, _ = check_run(WHOLE_CHECK_LR, w0=w0)
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


@spanned
def timed_manager(root, keep: int = 3):
    """A CheckpointManager that times every save() call (its blocking part:
    the copy to host, and the write too for a blocking save), wait() and
    restore()."""
    from repro_torch.checkpoint import CheckpointManager

    class TimedManager(CheckpointManager):
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

    return TimedManager(root, keep=keep)


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
    from repro_torch.configs import get_config
    from repro_torch.engine import CheckpointCallback, Engine
    from repro_torch.launch.train import kernel_launches
    from repro_torch.runtime import InjectedFailure, ResilienceConfig

    cfg = dc.replace(get_config("olmo-1b"), n_layers=RESTART_LAYERS)

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
        mgr = timed_manager(tmp, keep=3)
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
# elastic phase: the launcher's distributed code on one card
# ---------------------------------------------------------------------------

# olmo-1b at full width and 2 layers (the restart phase's model), 8 AsyncSAM
# AdamW steps, a checkpoint every 2 steps (asynchronous), and three events:
# a resize to 1 device at step 2, a grow to 2 at step 4 that one card cannot
# meet (skipped, no budget spent), a crash at step 5 restored onto the
# survivor.
ELASTIC_LAYERS, ELASTIC_STEPS, ELASTIC_SAVE_EVERY = 2, 8, 2
ELASTIC_EVENTS = ((2, 1, "resize"), (4, 2, "resize"), (5, 1, "crash"))


def elastic_phase() -> dict:
    """The launcher's fused path under --elastic on a world-1 NCCL group:
    `make_host_mesh` (a 1-device mesh, so the state is bucket-resident and
    the step runs the kernels), `FusedExecutor(mesh=, model_cfg=)`,
    `ElasticExecutor`, a `CheckpointCallback` and `Engine.fit(events=)`,
    against the same run uninterrupted and without checkpoints: the final
    params, mu, nu and carried ascent gradient equal bit for bit, one
    restart, two resizes, mesh_devices 1 every step, and every step's
    launches (the replayed ones too) those of the AdamW path."""
    import dataclasses as dc
    import shutil
    import socket
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.engine import Callback, CheckpointCallback, ElasticExecutor, Engine
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import kernel_launches
    from repro_torch.runtime import ChaosSchedule, MeshEvent, ResilienceConfig

    cfg = dc.replace(get_config("olmo-1b"), n_layers=ELASTIC_LAYERS)
    flash_n, _ = flash_per_step(cfg)
    want = {"flash_attention": flash_n, **dict.fromkeys(PATH_KERNELS["adamw"], 1)}

    class StepLaunches(Callback):
        """Each step's launches: the counts' difference across the step."""

        def __init__(self):
            self.last, self.rows = kernel_launches(), []

        def on_step(self, engine, state, metrics, step_time_s):
            now = kernel_launches()
            self.rows.append({k: now[k] - self.last[k] for k in now if now[k] - self.last[k]})
            self.last = now

    def buffers(state):
        return {"params": state.params.buffers[0], "mu": state.opt_state[0].mu.buffers[0],
                "nu": state.opt_state[0].nu.buffers[0],
                "ascent_grad": state.method_state.ascent_grad.buffers[0]}

    def run(events, mgr):
        mesh = make_host_mesh(model_axis=1, device="cuda")
        _, inner, state, pipe = build_trainer(ELASTIC_STEPS, LR, "adamw", cfg, mesh=mesh)
        if not (inner.resident and inner.fused_update and mesh.size == 1 and mesh.live):
            fail(f"elastic phase: a 1-device host mesh must run the resident fused path "
                 f"({mesh}, resident {inner.resident})")
        ex = ElasticExecutor(inner, model_cfg=cfg, model_axis=1)
        per_step = StepLaunches()
        cbs = [per_step]
        if mgr is not None:
            cbs.append(CheckpointCallback(mgr, ResilienceConfig(save_every=ELASTIC_SAVE_EVERY)))
        reset_launches()                                # counts: 0 just before
        per_step.last = kernel_launches()
        t0 = time.perf_counter()
        rep = Engine(ex, pipe, cbs).fit(state, ELASTIC_STEPS, events=events)
        wall_s = time.perf_counter() - t0
        launches = kernel_launches()                    # read just after
        return ex, rep, per_step.rows, launches, wall_s

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)                     # this rank's card, before its group
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_elastic_"))
    try:
        _, clean, clean_rows, clean_launches, clean_s = run(None, None)
        clean_bufs = {k: v.clone() for k, v in buffers(clean.final_state).items()}
        del clean
        torch.cuda.empty_cache()
        mgr = timed_manager(tmp, keep=2)
        events = ChaosSchedule([MeshEvent(st, n, kind=k) for st, n, k in ELASTIC_EVENTS])
        ex, rep, rows, launches, wall_s = run(events, mgr)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        dist.destroy_process_group()
    got = buffers(rep.final_state)
    equal = {k: bool(torch.equal(got[k], clean_bufs[k])) for k in got}
    hist = rep.metrics_history
    marked = [m for m in hist if "resize_events" in m]
    out = dict(layers=ELASTIC_LAYERS, steps=rep.steps_done, restarts=rep.restarts,
               resize_events=ex.resize_events, bitwise_equal=equal,
               mesh_devices=[m["mesh_devices"] for m in hist],
               resize_time_s=[m["resize_time_s"] for m in marked],
               restore_s=mgr.times["restore"], save_s=mgr.times["save"], wait_s=mgr.times["wait"],
               per_step=rows, clean_per_step=clean_rows, clean_wall_s=clean_s, wall_s=wall_s,
               losses=[m["loss"] for m in hist])
    out["launches"] = {k: launches.get(k, 0) + clean_launches.get(k, 0)
                       for k in set(launches) | set(clean_launches)}
    print(f"elastic: olmo-1b at full width, {ELASTIC_LAYERS} layers, {ELASTIC_STEPS} AsyncSAM "
          f"AdamW steps on a 1-device host mesh (world-1 NCCL group), save every "
          f"{ELASTIC_SAVE_EVERY}, events {ELASTIC_EVENTS}: {json.dumps(out)}")
    print(f"elastic: resize_time_s {out['resize_time_s']}, restore {out['restore_s']} s")
    problems = []
    if not (rep.restarts == 1 and ex.resize_events == 2 and rep.steps_done == ELASTIC_STEPS):
        problems.append("one restart, two resizes and every step done expected")
    if not all(equal.values()):
        problems.append(f"not the uninterrupted run bit for bit: {equal}")
    if out["mesh_devices"] != [1.0] * len(hist) or len(marked) != 2:
        problems.append("mesh_devices 1.0 every step and two resize markers expected")
    # the chaos run takes every step once and replays the steps after its
    # last checkpoint (steps 5 of 8 restored from step 4: 9 steps)
    if len(rows) != ELASTIC_STEPS + 1 or any(r != want for r in rows + clean_rows):
        problems.append(f"every step's launches must be {want}")
    if not all(math.isfinite(v) for m in hist for v in m.values()):
        problems.append("non-finite metrics")
    if problems:
        fail(f"elastic phase: {problems}")
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

# 3 layers (6 before the examples phase came in: the deepest whose snapshot
# fits the wire's 2 GiB frame, 2.02 GB; at 3 a snapshot is 1.22 GB and each
# exchange's GRAD framing, most of the phase's time, shrinks with it); 3
# steps: the snapshot and two int8 deltas, the second applied on the first
# (a fourth step, a third delta, took ~8 s of an H100 host's run)
REMOTE_LAYERS, REMOTE_STEPS = 3, 3
REMOTE_LOSS_SPEC = "chip_smoke:olmo_remote_loss"
_OLMO_REMOTE: list = []


def olmo_remote_loss(params, batch, gen=None):
    """The loss of olmo-1b at full width and REMOTE_LAYERS layers: what the
    remote phase's ascent server holds (`--loss chip_smoke:olmo_remote_loss`;
    the loss specs have no depth override)."""
    if not _OLMO_REMOTE:
        from repro_torch.configs import get_config
        from repro_torch.models import build_model
        _OLMO_REMOTE.append(build_model(dataclasses.replace(get_config("olmo-1b"),
                                                            n_layers=REMOTE_LAYERS)))
    return _OLMO_REMOTE[0].loss_fn(params, batch, gen)


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
               ascent_exchange_spans=sum(sp.name == "ascent_exchange" for sp in sink.spans))
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
# CPU ascent of one 512-token sequence took ~8 s against a ~0.07 s descent
# step on an H100 host; 256 tokens since the run neared its time limit), at
# most HETERO_MAX_S seconds of stepping
HETERO_LAYERS, HETERO_SEQ, HETERO_STEPS, HETERO_MAX_S = 2, 256, 10, 60.0


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
               loss_first=hist[0]["loss"], loss_last=hist[-1]["loss"], overlap=overlap)
    print("hetero " + json.dumps(out))
    if not all(math.isfinite(m["loss"]) for m in hist) or ex.ledger.refreshes < 1:
        fail(f"hetero phase: finite losses and a fresh ascent harvested needed: {out}")
    del ex, state, pipe
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# examples phase: the user scripts of `repro_torch.examples` on the card
# ---------------------------------------------------------------------------

def examples_phase() -> dict:
    """quickstart and hetero_async_sam through their `main()` on the card at
    their default sizes (quickstart: reduced olmo-1b, 200 AsyncSAM AdamW
    steps of 8 x 64 tokens; hetero_async_sam: the 64-1024-1024-1024-10 MLP,
    60 steps of 1,024 rows each of SGD, SAM and AsyncSAM at b/b' 2 and 4 with
    the ascent lane on the CPU); each one's launches counted from 0 just
    before it and read just after."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.examples import hetero_async_sam, quickstart
    from repro_torch.launch.train import kernel_launches

    runs = {}
    for name, mod in (("quickstart", quickstart), ("hetero_async_sam", hetero_async_sam)):
        reset_launches()                               # counts: 0 just before
        t0 = time.perf_counter()
        res = mod.main(["--device", "cuda"])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = kernel_launches()                   # read just after
        runs[name] = dict(result=res, wall_s=wall_s, launches=launches)
        final = res["final_loss"] if name == "quickstart" else {
            k: v["final_loss"] for k, v in res.items()}
        print(f"example {name}: final loss {final}, wall time {wall_s:.2f}s, "
              f"launches {launches}")
    q, h = runs["quickstart"], runs["hetero_async_sam"]
    problems = []
    qr = q["result"]
    flash_n, _ = flash_per_step(get_config("olmo-1b", reduced=True))
    want_q = {"flash_attention": flash_n * qr["steps"], "adamw_epilogue": qr["steps"]}
    if {k: q["launches"][k] for k in want_q} != want_q:
        problems.append(f"quickstart launches {q['launches']}, expected {want_q}")
    if not (math.isfinite(qr["final_loss"]) and qr["final_loss"] < qr["first_loss"]):
        problems.append(f"quickstart loss {qr['first_loss']} -> {qr['final_loss']}")
    for run, r in h["result"].items():
        if not (math.isfinite(r["final_loss"]) and r["acc"] > 0.1):
            problems.append(f"hetero_async_sam {run}: {r}")
    if h["launches"]["sgd_epilogue"] < 1 or h["launches"]["sam_perturb"] < 1:
        problems.append(f"hetero_async_sam launches {h['launches']}")
    if problems:
        fail(f"examples phase: {problems}")
    out = {name: dict(wall_s=r["wall_s"], launches=r["launches"]) for name, r in runs.items()}
    out["quickstart"].update(final_loss=qr["final_loss"], first_loss=qr["first_loss"])
    out["hetero_async_sam"].update(
        {run: {k: r[k] for k in ("time_s", "acc", "final_loss", "ledger") if k in r}
         for run, r in h["result"].items()})
    print("examples " + json.dumps(out))
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


@spanned
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
    from repro_torch.kernels import rwkv6_scan as r6
    b, s, h, dk, dv = shape
    es = 2 if dtype == "bfloat16" else 4
    tok = b * s * h
    state = 4 * b * h * dk * dv
    inputs = tok * (2 * dk + dv) * es + tok * dk * 4 + h * dk * 4 + (state if init else 0)
    if backward:     # + dy, dS_T; out dr, dk, dv, dw, du, d init_state
        nbytes = inputs + tok * dv * es + state + tok * (2 * dk + dv) * es + tok * dk * 4 \
            + h * dk * 4 + state
        ops = r6.RWKV_BWD_OPS * tok * dk * dv
    else:            # out y, the final state
        nbytes = inputs + tok * dv * es + state
        ops = r6.RWKV_FWD_OPS * tok * dk * dv
    return bound(nbytes, ops)


@spanned
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
    """Both wkv kernels against their plain versions at RWKV_CASES, timed
    (the plain versions on one warm call by CUDA events, the call before it
    giving the result they are checked against: `result_and_ms`); the
    forward run twice (the same bits); returns the model shape's row per
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
        (y_p, state_p), plain_ms = result_and_ms(
            lambda: ref.rwkv6_scan_plain(r, k, v, w, u, s0))
        ok = (wkv_ok(y, y_p, RWKV_FP32_TOL) and wkv_ok(state, state_p, RWKV_FP32_TOL)
              and same_bits)
        err = max(wkv_error(y, y_p)[0], wkv_error(state, state_p)[0])
        del y, state, y_p, state_p
        ms = time_ms(lambda: r6.rwkv6_scan(r, k, v, w, u, s0))
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
        want, plain_ms = result_and_ms(lambda: plain_wkv_grads(r, k, v, w, u, s0, dy, ds))
        names = ("dr", "dk", "dv", "dw", "du", "d_init_state")
        errs = {n_: wkv_error(a, e) for n_, a, e in zip(names, got, want)}
        ok_b = all(a.shape == e.shape and a.dtype == e.dtype and wkv_ok(a, e, RWKV_GRAD_TOL)
                   for a, e in zip(got, want))
        del got, want
        ms = time_ms(lambda: r6._launch_bwd(r, k, v, w, u, s0, dy, ds))
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


# rwkv6's "tp" layout on a 16-way model axis, one card standing in for the
# ranks: the wkv kernels on a rank's 4 of the 64 heads at the model's scan
# shape, their inputs strided views of the whole call's (the wrapper makes
# them contiguous), and one full-width layer's 16 time-mix (head) and
# channel-mix (d_ff) shares against the whole layer
TP_RANKS, WKV_SHAPE = 16, (8, 1024, 64, 64, 64)
RWKV_SHARE_TOKENS = (2, 1024)


def rwkv_local_heads_phase() -> dict:
    """The wkv kernels, forward and backward, on a rank's 64 / TP_RANKS
    heads of WKV_SHAPE (bf16 r/k/v, seed 3; the cotangents seed 4) through
    the wrapper on strided views, against their plain versions on the first
    PLAIN_GRAD_BATCH rows (y and the state within RWKV_FP32_TOL of their
    max, the fp32 gradients within RWKV_GRAD_TOL, bf16 outputs bf16's
    tolerance, as `rwkv_kernel_phase`); each kernel timed at WKV_SHAPE's
    batch on the rank's contiguous heads (as the model hands them over)
    beside the whole 64-head call, the wrapper's call on the views (their
    copies included) too; the plain versions on the checked rows
    (`result_and_ms`). Fails on a disagreement."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as r6

    b, s, h, dk, dv = WKV_SHAPE
    n = h // TP_RANKS
    r, k, v, w, u, _ = wkv_inputs(WKV_SHAPE, "bfloat16", False)
    g = torch.Generator(device="cuda").manual_seed(4)
    dy = torch.randn((b, s, h, dv), generator=g, device="cuda").to(r.dtype)
    ds = torch.randn((b, h, dk, dv), generator=g, device="cuda")
    views = [t.narrow(2, 0, n) for t in (r, k, v, w)] + [u[:n]]
    loc = [t.contiguous() for t in views]
    dy_l, ds_l = dy[:, :, :n].contiguous(), ds[:, :n].contiguous()
    strided = not views[0].is_contiguous()

    # the check on the first PLAIN_GRAD_BATCH rows (the plain backward of
    # all 8 takes ~5 s), the times on all of them
    rows_ = slice(0, PLAIN_GRAD_BATCH)
    views_c = [t[rows_] for t in views[:4]] + [views[4]]
    loc_c = [t[rows_] for t in loc[:4]] + [loc[4]]
    y, state = r6.rwkv6_scan(*views_c)
    (y_p, state_p), plain_fwd_ms = result_and_ms(lambda: ref.rwkv6_scan_plain(*loc_c))
    ok_f = wkv_ok(y, y_p, RWKV_FP32_TOL) and wkv_ok(state, state_p, RWKV_FP32_TOL)
    err_f = max(wkv_error(y, y_p)[0], wkv_error(state, state_p)[0])
    leaves = [t.detach().requires_grad_() for t in views_c]
    y, state = r6.rwkv6_scan(*leaves)
    got = torch.autograd.grad([y, state], leaves, [dy[rows_, :, :n], ds[rows_, :n]])
    want, plain_bwd_ms = result_and_ms(
        lambda: plain_wkv_grads(*loc_c, None, dy_l[rows_], ds_l[rows_])[:5])
    ok_b = all(a.shape == e.shape and wkv_ok(a, e, RWKV_GRAD_TOL) for a, e in zip(got, want))
    err_b = max(wkv_error(a, e)[0] for a, e in zip(got, want))
    del y, state, y_p, state_p, leaves, got, want
    shape = (b, s, n, dk, dv)
    rows = {}
    for name, backward in (("rwkv6_scan_fwd", False), ("rwkv6_scan_bwd", True)):
        if backward:
            def local():
                return r6._launch_bwd(*loc, None, dy_l, ds_l)

            def whole():
                return r6._launch_bwd(r, k, v, w, u, None, dy, ds)
        else:
            def local():
                return r6._launch_fwd(*loc, None)

            def whole():
                return r6._launch_fwd(r, k, v, w, u, None)
        ms, whole_ms = time_ms(local), time_ms(whole)
        ms2, whole_ms2 = time_ms(local), time_ms(whole)
        bound_ms, bound_by = wkv_bound(shape, "bfloat16", False, backward)
        rows[name] = dict(
            kernel=name, case=f"rwkv6-7b scan, {n} of {h} heads (a rank's on {TP_RANKS})",
            shape=shape, dtype="bfloat16", strided_views=strided, checked_rows=PLAIN_GRAD_BATCH,
            max_abs_err=err_b if backward else err_f, ok=ok_b if backward else ok_f,
            ms=ms, ms_again=ms2, whole_ms=whole_ms, whole_ms_again=whole_ms2,
            whole_over_local=whole_ms / ms, plain_ms=plain_bwd_ms if backward else plain_fwd_ms,
            library_ms=None,
            bound_ms=bound_ms, bound_by=bound_by)
    rows["rwkv6_scan_fwd"]["wrapper_on_views_ms"] = time_ms(lambda: r6.rwkv6_scan(*views))
    for row in rows.values():
        print("rwkv local heads " + json.dumps(row))
    del r, k, v, w, u, dy, ds, views, loc
    torch.cuda.empty_cache()
    if not all(row["ok"] for row in rows.values()):
        fail(f"the wkv kernels on {n} heads disagree with their plain versions")
    return rows


@spanned
def rwkv_share_sums(cfg, tm: dict, cm: dict, x32, wt, m: int):
    """(y, the gradients of x32 and of every tm and cm leaf) of one rwkv6
    layer's time mix plus channel mix as m ranks of the "tp" layout compute
    them, summed as their collectives sum them: each rank on its own bf16
    copy of x for each mix (f's input), its time-mix part (`timemix_part` on
    `partitioning.rwkv_share`) and its channel value (`channel_value`) added
    in bf16 rank after rank, as a ring all-reduce (g) and reduce-scatter
    round at every hop; each rank's gate on its columns of the summed value,
    joined (the all-gather); each mix's m gradients of its x copies added in
    bf16 the same way (f's backward all-reduce), then the two mixes' added;
    the leaves' in fp32, as the partial leaves' gradient sync sums them. The
    loss is (y * wt).sum()."""
    import torch
    from repro_torch.models import partitioning
    from repro_torch.models import rwkv as RWKV

    dt = getattr(torch, cfg.compute_dtype)
    xt = [x32.detach().to(dt).requires_grad_() for _ in range(m)]
    xc = [x32.detach().to(dt).requires_grad_() for _ in range(m)]
    tm_parts, values, xrs = [], [], []
    for r in range(m):
        tm_parts.append(RWKV.timemix_part(partitioning.rwkv_share("tm", tm, r, m), xt[r], cfg,
                                          r, m)[0])
        prev = RWKV._token_shift(xc[r], None)[0]
        values.append(RWKV.channel_value(partitioning.rwkv_share("cm", cm, r, m),
                                         RWKV._lerp(xc[r], prev, cm["mix_k"]), cfg))
        xrs.append(RWKV._lerp(xc[r], prev, cm["mix_r"]))
    v, w = ring(values), cfg.d_model // m
    out_c = torch.cat([RWKV.channel_gate(partitioning.rwkv_share("cm", cm, r, m), xrs[r],
                                         v[..., r * w:(r + 1) * w], cfg) for r in range(m)], dim=-1)
    y = ring(tm_parts).float() + out_c.float()
    grads = torch.autograd.grad((y * wt).sum(), xt + xc + [*tm.values(), *cm.values()])
    gx = (ring(grads[:m]) + ring(grads[m:2 * m])).float()
    return y.detach(), [gx, *grads[2 * m:]]


def rwkv_share_phase() -> dict:
    """One full-width rwkv6-7b layer's mixes (fp32 weights from seed 2,
    matrices at std 1/sqrt(fan-in), the other leaves 0.3 N(0, 1) with w0
    shifted by -2; bf16 compute) on x of RWKV_SHARE_TOKENS: the TP_RANKS
    time-mix (4 heads each) and channel-mix (896 of d_ff, 256 of d_model
    each) shares summed as the program's collectives sum them
    (`rwkv_share_sums`, in bf16 where they move bf16), held against the
    whole `timemix_apply` + `channelmix_apply` within BF16_TOL of its max
    (`held`), and so are the gradients of x and of every leaf (a loss of y
    against fixed random weights). A rank's forward timed beside the whole
    layer's. Fails on a disagreement."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import partitioning
    from repro_torch.models import rwkv as RWKV

    cfg = get_config("rwkv6-7b")
    m, d = TP_RANKS, cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(2)

    def init(shapes):
        return {k: (torch.randn(sh, generator=gen, device="cuda")
                    * (sh[-2] ** -0.5 if len(sh) == 2 else 0.3)).requires_grad_()
                for k, sh in shapes.items()}

    tm, cm = init(RWKV.timemix_shapes(cfg)), init(RWKV.channelmix_shapes(cfg))
    with torch.no_grad():
        tm["w0"].sub_(2.0)
    dt = getattr(torch, cfg.compute_dtype)
    x32 = torch.randn(*RWKV_SHARE_TOKENS, d, generator=gen, device="cuda"
                      ).to(dt).float().requires_grad_()
    wt = torch.randn(*RWKV_SHARE_TOKENS, d, generator=gen, device="cuda")
    names = ["x"] + [f"tm.{k}" for k in tm] + [f"cm.{k}" for k in cm]

    xb = x32.to(dt)
    y = (RWKV.timemix_apply(tm, xb, cfg)[0].float()
         + RWKV.channelmix_apply(cm, xb, cfg)[0].float())
    want = torch.autograd.grad((y * wt).sum(), [x32, *tm.values(), *cm.values()])
    y = y.detach()
    total, got = rwkv_share_sums(cfg, tm, cm, x32, wt, m)
    checks = {"y": held(total, y, BF16_TOL)}
    for name, g, g_want in zip(names, got, want):
        checks[f"{name}_grad"] = held(g, g_want, BF16_TOL)
    del got, want, total
    w = d // m
    with torch.no_grad():
        tm0, cm0 = partitioning.rwkv_share("tm", tm, 0, m), partitioning.rwkv_share("cm", cm, 0, m)
        prev = RWKV._token_shift(xb, None)[0]
        xk, xr = RWKV._lerp(xb, prev, cm["mix_k"]), RWKV._lerp(xb, prev, cm["mix_r"])

        def one_rank():
            RWKV.timemix_part(tm0, xb, cfg, 0, m)
            RWKV.channel_gate(cm0, xr, RWKV.channel_value(cm0, xk, cfg)[..., :w], cfg)

        def whole_layer():
            RWKV.timemix_apply(tm, xb, cfg)
            RWKV.channelmix_apply(cm, xb, cfg)

        whole_ms, rank_ms = time_ms(whole_layer), time_ms(one_rank)
    worst = max(checks, key=lambda k: checks[k][2])
    row = dict(case=f"rwkv6-7b layer, {m} head / d_ff shares", tokens=RWKV_SHARE_TOKENS,
               heads_a_share=d // cfg.rwkv.head_dim // m, d_ff_a_share=cfg.d_ff // m,
               d_model_a_share=w, held=len(checks), sums="bf16 rank after rank",
               ok=all(c[0] for c in checks.values()),
               worst=worst, worst_err_over_max=checks[worst][2],
               y_err_over_max=checks["y"][2], x_grad_err_over_max=checks["x_grad"][2],
               failed=[k for k, c in checks.items() if not c[0]],
               atol=BF16_TOL["atol"], rtol=BF16_TOL["rtol"], whole_ms=whole_ms,
               rank_ms=rank_ms, whole_over_rank=whole_ms / rank_ms)
    print("rwkv shares " + json.dumps(row))
    print("rwkv shares, each check's max |d| over max |want|: "
          + json.dumps({k: c[2] for k, c in checks.items()}))
    del tm, cm, x32, wt, xb, y
    torch.cuda.empty_cache()
    if not row["ok"]:
        fail(f"rwkv6's {m} time-mix and channel-mix shares disagree with the whole layer: "
             f"{row['failed']}")
    return row


# rwkv6's time mix in the "tp" layout's column branch: "model" divides
# d_model (4096) but not the 64 heads, so each rank computes r, k, v and g
# on its d_model / COLUMN_RANKS columns, half a head here
COLUMN_RANKS = 128


@spanned
def rwkv_column_sums(cfg, tm: dict, x32, wt, m: int, summed: bool = True):
    """rwkv6's time mix as m ranks of the column layout compute it: each
    rank on its own bf16 copy of x (f's input) takes r, k, v, g and the
    decay's input on its columns (`timemix_project` on
    `partitioning.rwkv_share`), r, k and v are joined whole (the
    all-gather), each rank runs the decay, the wkv kernels and the norm on
    every head (`timemix_scan`) and its columns of y through its rows of wo
    (`timemix_gate_out`); autograd adds the ranks' gradients of the joined
    r, k and v (the reduce-scatter's sum: two ranks' non-zero parts a
    column, those of its head's two shares). `summed` False is the control:
    rank j's scan reads the other ranks' columns detached, so its columns
    of r, k and v get its own gradient alone. Each rank's two pieces are
    checkpointed (recomputed in backward), which keeps 128 ranks'
    activations within the card. The loss is (y * wt).sum().

    Returns (y, the gradients of x32 and of every tm leaf, y and x's
    gradient summed in bf16): y is the ranks' outputs summed in fp32 and
    rounded to bf16 once, as `timemix_apply`'s g sums them on this branch,
    and x's gradient the ranks' gradients of their x copies summed the
    same way (its f's backward); the last two are the same sums added in
    bf16 rank after rank, as a ring all-reduce of bf16 would add them (what
    the branch would give without its fp32 sums)."""
    import torch
    from torch.utils.checkpoint import checkpoint
    from repro_torch.models import partitioning
    from repro_torch.models import rwkv as RWKV

    dt = getattr(torch, cfg.compute_dtype)
    w = cfg.d_model // m
    xt = [x32.detach().to(dt).requires_grad_() for _ in range(m)]
    shares = [partitioning.rwkv_share("tm", tm, r, m) for r in range(m)]

    def project(share, x):
        p = RWKV.timemix_project(share, x, cfg)
        return p["r"], p["k"], p["v"], p["g"], p["xw"]

    def scan_out(r, share, rr, kk, vv, xw, g):
        y, _ = RWKV.timemix_scan(share, rr, kk, vv, xw, cfg)
        return RWKV.timemix_gate_out(share, y[..., r * w:(r + 1) * w], g, cfg, r * w,
                                     (r + 1) * w)

    pieces = [checkpoint(project, shares[r], xt[r], use_reentrant=False) for r in range(m)]
    joined = [torch.cat([p[i] for p in pieces], dim=-1) for i in range(3)]
    parts = []
    for r, p in enumerate(pieces):
        if summed:
            rkv = joined
        else:
            rkv = [torch.cat([q[i] if j == r else q[i].detach() for j, q in enumerate(pieces)],
                             dim=-1) for i in range(3)]
        parts.append(checkpoint(scan_out, r, shares[r], *rkv, p[4], p[3], use_reentrant=False))
    y = torch.stack([t.float() for t in parts]).sum(0).to(dt).float()
    y16 = ring([t.detach() for t in parts]).float()
    del parts, pieces, joined
    grads = torch.autograd.grad((y * wt).sum(), xt + list(tm.values()))
    gx = torch.stack([g.float() for g in grads[:m]]).sum(0).to(dt).float()
    return y.detach(), [gx, *grads[m:]], y16, ring(grads[:m]).float()


def rwkv_column_share_phase() -> dict:
    """One full-width rwkv6-7b time mix (fp32 weights from seed 2, as
    `rwkv_share_phase`'s; bf16 compute) on x of RWKV_SHARE_TOKENS: the
    COLUMN_RANKS column shares composed as the program's collectives
    compose them (`rwkv_column_sums`: their outputs and x's gradients
    summed in fp32 and rounded once, as the branch's f and g sum them),
    held against the whole `timemix_apply` within BF16_TOL of its max
    (`held`), and so are the gradients of every leaf (a loss of y against
    fixed random weights); the control (each share's gradient of the
    joined r, k and v its own alone) must miss on wr, wk or wv. The same
    sums added in bf16 rank after rank, as bf16 ring all-reduces over 128
    ranks would add them, are reported beside them: they are why the
    branch sums in fp32 (the 16 head shares of `rwkv_share_phase` hold
    with bf16 sums, as their branch adds them). A share's forward (its
    columns, the scan on the joined r, k and v, its gate and rows of wo)
    timed beside the whole time mix's. Fails on a
    disagreement or a control that holds."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import partitioning
    from repro_torch.models import rwkv as RWKV

    cfg = get_config("rwkv6-7b")
    m, d = COLUMN_RANKS, cfg.d_model
    heads = d // cfg.rwkv.head_dim
    if heads % m == 0 or d % m:
        fail(f"rwkv column shares: {m} ranks must divide d_model {d} and not its {heads} heads")
    gen = torch.Generator(device="cuda").manual_seed(2)
    tm = {k: (torch.randn(sh, generator=gen, device="cuda")
              * (sh[-2] ** -0.5 if len(sh) == 2 else 0.3)).requires_grad_()
          for k, sh in RWKV.timemix_shapes(cfg).items()}
    with torch.no_grad():
        tm["w0"].sub_(2.0)
    dt = getattr(torch, cfg.compute_dtype)
    x32 = torch.randn(*RWKV_SHARE_TOKENS, d, generator=gen, device="cuda"
                      ).to(dt).float().requires_grad_()
    wt = torch.randn(*RWKV_SHARE_TOKENS, d, generator=gen, device="cuda")
    names = ["x"] + [f"tm.{k}" for k in tm]

    xb = x32.to(dt)
    y = RWKV.timemix_apply(tm, xb, cfg)[0].float()
    want = torch.autograd.grad((y * wt).sum(), [x32, *tm.values()])
    y = y.detach()
    checks, missed, rings = {}, {}, {}
    for summed in (True, False):
        total, got, y16, gx16 = rwkv_column_sums(cfg, tm, x32, wt, m, summed)
        for name, g, g_want in zip(["y"] + [f"{n}_grad" for n in names], [total, *got],
                                   [y, *want]):
            (checks if summed else missed)[name] = held(g, g_want, BF16_TOL)
        if summed:
            rings = {"y": held(y16, y, BF16_TOL), "x_grad": held(gx16, want[0], BF16_TOL)}
        del total, got, y16, gx16
    del want
    torch.cuda.empty_cache()
    w = d // m
    with torch.no_grad():
        share0 = partitioning.rwkv_share("tm", tm, 0, m)
        whole_p = RWKV.timemix_project(tm, xb, cfg)

        def one_rank():
            p = RWKV.timemix_project(share0, xb, cfg)
            y0, _ = RWKV.timemix_scan(share0, whole_p["r"], whole_p["k"], whole_p["v"],
                                      p["xw"], cfg)
            RWKV.timemix_gate_out(share0, y0[..., :w], p["g"], cfg, 0, w)

        def whole_mix():
            RWKV.timemix_apply(tm, xb, cfg)

        whole_ms, rank_ms = time_ms(whole_mix), time_ms(one_rank)
    worst = max(checks, key=lambda k: checks[k][2])
    control_missed = [k for k, c in missed.items() if not c[0]]
    row = dict(case=f"rwkv6-7b time mix, {m} column shares", tokens=RWKV_SHARE_TOKENS,
               columns_a_share=w, heads_a_share=w / cfg.rwkv.head_dim, held=len(checks),
               sums="fp32, rounded once (y, x's gradient)", ok=all(c[0] for c in checks.values()),
               worst=worst, worst_err_over_max=checks[worst][2],
               y_err_over_max=checks["y"][2], x_grad_err_over_max=checks["x_grad"][2],
               failed=[k for k, c in checks.items() if not c[0]],
               control_missed=control_missed,
               control_wr_grad_err_over_max=missed["tm.wr_grad"][2],
               bf16_ring_y_err_over_max=rings["y"][2],
               bf16_ring_x_grad_err_over_max=rings["x_grad"][2],
               bf16_ring_within_tol={k: r[0] for k, r in rings.items()},
               atol=BF16_TOL["atol"], rtol=BF16_TOL["rtol"], whole_ms=whole_ms,
               rank_ms=rank_ms, whole_over_rank=whole_ms / rank_ms)
    print("rwkv column shares " + json.dumps(row))
    print("rwkv column shares, each check's max |d| over max |want| (control after the "
          "slash): " + json.dumps({k: f"{c[2]:.4e} / {missed[k][2]:.4e}"
                                   for k, c in checks.items()}))
    del tm, x32, wt, xb, y, share0, whole_p
    torch.cuda.empty_cache()
    if not row["ok"]:
        fail(f"rwkv6's {m} column shares of the time mix disagree with the whole time mix: "
             f"{row['failed']}")
    if not {"tm.wr_grad", "tm.wk_grad", "tm.wv_grad"} & set(control_missed):
        fail("rwkv column shares: the control (the joined r, k and v's gradients not summed "
             "over the shares) meets the tolerance on wr, wk and wv")
    return row


# The wkv scan chained over WKV_CHAIN_BLOCKS sequence blocks as the
# "fsdp_sp" profile's ranks run it (`models.rwkv`), at rwkv6-7b's heads: a
# sequence of WKV_CHAIN_SHAPE, bf16 r/k/v. The log decay w = -exp(N(0, 0.5)
# - 6), slower than `wkv_inputs`' (a block's 256 steps keep exp(-0.6) of a
# channel's state on average), so that the entering state is a share of
# every block's output (a control without the chain must miss).
WKV_CHAIN_SHAPE, WKV_CHAIN_BLOCKS = (2, 4096, 64, 64, 64), 16


@spanned
def chained_wkv(r, k, v, w, u, blocks: int, chain: bool = True):
    """(y, final state) of the wkv kernels over `blocks` blocks: each block
    from no state (its final state and per-key log decay, the block's sum
    of w), the exclusive prefix of the stacked lists
    (`utils.distributed.state_prefix`), each block again from it. Without
    `chain`, each block from no state (the control)."""
    import torch
    from repro_torch.kernels import rwkv6_scan as r6
    from repro_torch.utils import distributed
    n = r.shape[1] // blocks
    parts = [[t[:, i * n:(i + 1) * n].contiguous() for t in (r, k, v, w)]
             for i in range(blocks)]
    first = [r6.rwkv6_scan(*p, u) for p in parts]
    if not chain:
        return torch.cat([y for y, _ in first], dim=1), first[-1][1]
    s_all = torch.stack([st for _, st in first])
    l_all = torch.stack([p[3].sum(dim=1) for p in parts])
    out = [r6.rwkv6_scan(*p, u, init_state=distributed.state_prefix(s_all, l_all, i))
           for i, p in enumerate(parts)]
    return torch.cat([y for y, _ in out], dim=1), out[-1][1]


def rwkv_chain_phase() -> dict:
    """The chained wkv scan's y, final state and the gradients of <y, gy> +
    <state, gs> with respect to r, k, v, w and u (the backward kernel
    through both passes and the prefix) against one whole-sequence kernel
    call: y and the state within RWKV_FP32_TOL of their max (bf16 y the
    reference's bf16 tolerance), the fp32 gradients within RWKV_GRAD_TOL,
    the bf16 ones bf16's (`wkv_ok`); the control (no chain) must miss y's
    limit; the chain's launches counted (2 x WKV_CHAIN_BLOCKS forward, as
    many backward); its forward and backward timed beside the whole
    call's. Fails on a disagreement."""
    import torch
    from repro_torch.kernels import rwkv6_scan as r6

    b, s, h, dk, dv = WKV_CHAIN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(12)

    def n(*sh, scale=0.5):
        return torch.randn(sh, generator=gen, device="cuda") * scale

    r, k, v = (n(b, s, h, dk).to(torch.bfloat16) for _ in range(3))
    w = -torch.exp(n(b, s, h, dk) - 6.0)
    u = n(h, dk, scale=0.1)
    args = [t.requires_grad_() for t in (r, k, v, w, u)]
    gy, gs = n(b, s, h, dv, scale=1.0).to(torch.bfloat16), n(b, h, dk, dv, scale=1.0)
    y_w, s_w = r6.rwkv6_scan(*args)
    g_w = torch.autograd.grad([y_w, s_w], args, [gy, gs])
    before = dict(r6.launches)
    y_c, s_c = chained_wkv(*args, blocks=WKV_CHAIN_BLOCKS)
    g_c = torch.autograd.grad([y_c, s_c], args, [gy, gs])
    torch.cuda.synchronize()
    launches = {key: r6.launches[key] - before[key] for key in before}
    names = ("dr", "dk", "dv", "dw", "du")
    with torch.no_grad():
        y_n, _ = chained_wkv(*args, blocks=WKV_CHAIN_BLOCKS, chain=False)
        errs = {"y": wkv_error(y_c, y_w), "state": wkv_error(s_c, s_w),
                **{nm: wkv_error(a, e) for nm, a, e in zip(names, g_c, g_w)}}
        ok = (wkv_ok(y_c, y_w, RWKV_FP32_TOL) and wkv_ok(s_c, s_w, RWKV_FP32_TOL)
              and all(wkv_ok(a, e, RWKV_GRAD_TOL) for a, e in zip(g_c, g_w))
              and not wkv_ok(y_n, y_w, RWKV_FP32_TOL)
              and launches == {"rwkv6_scan_fwd": 2 * WKV_CHAIN_BLOCKS,
                               "rwkv6_scan_bwd": 2 * WKV_CHAIN_BLOCKS})
        control = wkv_error(y_n, y_w)[1]
        del y_n
        whole_ms = time_ms(lambda: r6.rwkv6_scan(*args))
        chain_ms = time_ms(lambda: chained_wkv(*args, blocks=WKV_CHAIN_BLOCKS))

    def backward(fn):
        def run():
            y_, s_ = fn()
            torch.autograd.grad([y_, s_], args, [gy, gs])
        return run

    whole_bwd_ms = time_ms(backward(lambda: r6.rwkv6_scan(*args))) - whole_ms
    chain_bwd_ms = time_ms(backward(lambda: chained_wkv(*args, blocks=WKV_CHAIN_BLOCKS))) \
        - chain_ms
    row = dict(case=f"rwkv6-7b wkv, {WKV_CHAIN_BLOCKS} sequence blocks", shape=WKV_CHAIN_SHAPE,
               dtype="bfloat16", blocks=WKV_CHAIN_BLOCKS,
               max_rel_err={key: e[1] for key, e in errs.items()},
               max_abs_err=max(e[0] for e in errs.values()), control_rel_err=control,
               launches=launches, ok=ok, whole_ms=whole_ms, chain_ms=chain_ms,
               whole_bwd_ms=whole_bwd_ms, chain_bwd_ms=chain_bwd_ms)
    print("rwkv chained " + json.dumps(row))
    del args, r, k, v, w, u, gy, gs, y_w, s_w, g_w, y_c, s_c, g_c
    torch.cuda.empty_cache()
    if not ok:
        fail("the chained wkv scan disagrees with the whole call, or its control does not "
             f"miss: {row['max_rel_err']}, control {control}")
    return row


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

    with span("plain prefills"):
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
                err_fp32=err_fp32, requests=n_req, prompt_len=prompt_len, max_new=max_new), model


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
    Every run's buffers stay on the card (at most two runs' and the init w
    at once: at these cuts they fit beside a run, and copying them to the
    host took most of the check's time). Returns the comparisons, w's and
    the moments' bulk and the moments' limits."""
    def run(compute, plain, w0=None, coarse_bits=0):
        ccfg = dataclasses.replace(cfg, n_layers=layers, compute_dtype=compute)
        name = f"{compute} {'plain' if plain else 'kernel'}{' coarse' if coarse_bits else ''}"
        with span(name):
            return check_run(WHOLE_CHECK_LR, plain, w0, coarse_bits=coarse_bits, cfg=ccfg,
                             batch=batch, seq=seq)

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


# Training: full width at 2 layers (974,249,984 parameters; 4 until the run
# neared its time limit on a slow host); the whole-path check at 1 layer and
# batch 2 x 256, where autograd of the plain scan fits (at 2 layers its five
# 3-step runs took ~100 s of a run near its time limit; at 2 x 512 they
# took 72.5 s on one H100 against 48.8 at 2 x 256, when the run neared it
# again)
RWKV_TRAIN_LAYERS, RWKV_CHECK_LAYERS, RWKV_CHECK_BATCH, RWKV_CHECK_SEQ = 2, 1, 2, 256


def rwkv_per_step(cfg) -> dict:
    """Scan launches of one AsyncSAM step: 2 gradient passes, each running
    every block's forward once, and again in backward when the block is
    checkpointed, and every block's backward once."""
    fwd = 1 if cfg.remat == "none" else 2
    return {"rwkv6_scan_fwd": 2 * fwd * cfg.n_layers, "rwkv6_scan_bwd": 2 * cfg.n_layers}


@spanned
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
    with span("fit"):
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
    with span("profile"):
        out["profile"] = train_profile(ex, final, pipe)
    del report, state, final
    torch.cuda.empty_cache()

    # lockstep: every wkv call of one step against its plain version
    with span("lockstep"):
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
    with span("whole"):
        out.update(scan_whole_check("rwkv", "rwkv6", cfg, RWKV_CHECK_LAYERS, RWKV_CHECK_BATCH,
                                    RWKV_CHECK_SEQ))
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


def m2_flops(shape, backward: bool) -> float:
    """fp32 operations the SSD scan needs on this shape: the kernel module's
    count (M2_FWD_OPS or M2_BWD_OPS a state element and step), which its
    flop formula uses too."""
    from repro_torch.kernels import mamba2_scan as m2
    b, s, h, p, n, g = shape
    return float(m2.scan_flops((b, s, h, p), (b, s, g, n), backward))


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


@spanned
def m2_fwd_phase_ms(x, dt, a, b, c, d, s0) -> dict:
    """Device time of each phase of the SSD forward launched alone (CUDA
    events), on buffers that one whole forward filled first; with one chunk
    "out" is the whole forward and the other phases launch nothing."""
    from repro_torch.kernels import mamba2_scan as m2
    bufs = m2.fwd_buffers(x, b)
    m2.run_fwd(x, dt, a, b, c, d, s0, bufs)
    return {name: time_ms(lambda bit=bit: m2.run_fwd(x, dt, a, b, c, d, s0, bufs, bit))
            for name, bit in m2.FWD_PHASES.items()}


@spanned
def m2_bwd_phase_ms(x, dt, a, b, c, d, s0, dy, ds) -> dict:
    """Device time of each phase of the SSD backward launched alone (CUDA
    events), on buffers that one whole backward filled first."""
    from repro_torch.kernels import mamba2_scan as m2
    bufs = m2.bwd_buffers(x, b)
    m2.run_bwd(x, dt, a, b, c, d, s0, dy, ds, bufs)
    return {name: time_ms(lambda bit=bit: m2.run_bwd(x, dt, a, b, c, d, s0, dy, ds, bufs, bit))
            for name, bit in m2.BWD_PHASES.items()}


@spanned
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


@spanned
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


# The SSD scan chained over CHAIN_BLOCKS sequence blocks as the "fsdp_sp"
# profile's ranks run it (`models.ssm`), at zamba2-1.2b's width: (name, (B, S,
# H, P, N, G)). fp32 x/b/c, so that the chain and the whole call differ only
# in the order of their sums; dt ~ softplus(0.5 N(0, 1) + the model's
# dt_bias), about the model's 0.01 at init, so that a block's decay,
# exp(a sum dt) (exp(-2.6) to exp(-41) over 256 positions), leaves the
# entering state a share of every block's output (a control without the
# chain must miss).
CHAIN_CASES = [("zamba2-1.2b scan", (8, 1024, 64, 64, 64, 1)),
               ("zamba2-1.2b ascent scan", (2, 1024, 64, 64, 64, 1))]
CHAIN_BLOCKS = 4


@spanned
def chained_scan(x, dt, a, b, c, d, blocks: int, chain: bool = True):
    """(y, final state) of the SSD kernels over `blocks` blocks of the
    sequence: each block from no state (its final state S_r and log decay
    L_r = a sum dt), the exclusive prefix h_r of the stacked lists
    (`utils.distributed.state_prefix`, as each rank folds the gathered
    ones), each block again from h_r. Without `chain`, each block from no
    state (the control)."""
    import torch
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.utils import distributed
    w = x.shape[1] // blocks
    # each block's x, dt, b, c, contiguous as a rank holds them
    parts = [[t[:, r * w:(r + 1) * w].contiguous() for t in (x, dt, b, c)]
             for r in range(blocks)]
    first = [m2.mamba2_scan(xb, dtb, a, bb, cb, d) for xb, dtb, bb, cb in parts]
    if not chain:
        return torch.cat([y for y, _ in first], dim=1), first[-1][1]
    s_all = torch.stack([st for _, st in first])
    l_all = torch.stack([a * dtb.sum(dim=1) for _, dtb, _, _ in parts])
    out = [m2.mamba2_scan(xb, dtb, a, bb, cb, d,
                          init_state=distributed.state_prefix(s_all, l_all, r))
           for r, (xb, dtb, bb, cb) in enumerate(parts)]
    return torch.cat([y for y, _ in out], dim=1), out[-1][1]


def chained_scan_phase() -> list:
    """Each CHAIN_CASES shape: the chained scan's y, final state and the
    gradients of <y, gy> + <state, gs> with respect to x, dt, a, b, c and d
    (the backward kernel through both passes and the prefix) against one
    whole-sequence kernel call, each within FP32_TOL of its max; a control,
    the blocks without the chain, must miss y's limit; the chain's launches
    (2 x CHAIN_BLOCKS forward, as many backward) counted; the chain's
    forward timed beside the whole call's. Returns the rows."""
    import torch
    from repro_torch.kernels import mamba2_scan as m2

    rows, failures = [], []
    for case, shape in CHAIN_CASES:
        bsz, seq, h, p_, n, g = shape
        gen = torch.Generator(device="cuda").manual_seed(11)

        def rnd(*sh, scale=1.0):
            return torch.randn(sh, generator=gen, device="cuda") * scale

        x, bb, cc = rnd(bsz, seq, h, p_, scale=0.5), rnd(bsz, seq, g, n, scale=0.3), \
            rnd(bsz, seq, g, n, scale=0.3)
        dt = torch.nn.functional.softplus(rnd(bsz, seq, h, scale=0.5)
                                          + math.log(math.expm1(0.01)))
        a = -torch.linspace(1.0, 16.0, h, device="cuda")
        d = torch.full((h,), 0.5, device="cuda")
        args = [t.requires_grad_() for t in (x, dt, a, bb, cc, d)]
        gy, gs = rnd(bsz, seq, h, p_), rnd(bsz, h, p_, n)
        y_w, s_w = m2.mamba2_scan(*args)
        g_w = torch.autograd.grad((y_w * gy).sum() + (s_w * gs).sum(), args)
        before = dict(m2.launches)
        y_c, s_c = chained_scan(*args, blocks=CHAIN_BLOCKS)
        g_c = torch.autograd.grad((y_c * gy).sum() + (s_c * gs).sum(), args)
        torch.cuda.synchronize()
        launches = {k: m2.launches[k] - before[k] for k in before}
        with torch.no_grad():
            y_n, _ = chained_scan(*args, blocks=CHAIN_BLOCKS, chain=False)
            errs = {"y": wkv_error(y_c, y_w), "state": wkv_error(s_c, s_w)}
            errs.update({f"d{nm}": wkv_error(u, w)
                         for nm, u, w in zip(("x", "dt", "a", "b", "c", "d"), g_c, g_w)})
            control = wkv_error(y_n, y_w)[1]
            ms = time_ms(lambda: m2.mamba2_scan(*args))
            chain_ms = time_ms(lambda: chained_scan(*args, blocks=CHAIN_BLOCKS))
        tol = FP32_TOL["rtol"]
        ok = (all(e[1] <= tol for e in errs.values()) and control > tol
              and launches == {"mamba2_scan_fwd": 2 * CHAIN_BLOCKS,
                               "mamba2_scan_bwd": 2 * CHAIN_BLOCKS}
              and bool(torch.isfinite(y_c).all()))
        row = dict(case=case, shape=shape, blocks=CHAIN_BLOCKS,
                   max_rel_err={k: e[1] for k, e in errs.items()},
                   max_abs_err=max(e[0] for e in errs.values()), tol=tol,
                   control_rel_err=control, launches=launches, ok=ok, whole_ms=ms,
                   chain_ms=chain_ms)
        print("mamba2 chained " + json.dumps(row))
        rows.append(row)
        if not ok:
            failures.append(case)
        del args, x, dt, a, bb, cc, d, gy, gs, y_w, s_w, g_w, y_c, s_c, g_c, y_n
        torch.cuda.empty_cache()
    if failures:
        fail(f"the chained SSD scan disagrees with the whole call, or its control does "
             f"not miss: {failures}")
    return rows


# One full-width zamba2-1.2b mamba2 layer in the TP_RANKS shares its ranks
# compute under the "tp" layout (`models.ssm`: 4 of its 64 heads a share,
# `partitioning.mamba_share`), bf16 compute at x MAMBA_SHARE_TOKENS; and the
# SSD kernels on a rank's 4 heads at the model's scan shape, as the layer
# hands them over (its own contiguous projections, B and C whole).
MAMBA_SHARE_TOKENS = (2, 1024)
SSD_SHAPE = (8, 1024, 64, 64, 64, 1)


@spanned
def mamba_share_sums(cfg, leaves: dict, x32, wt, m: int):
    """(y, the gradients of x32 and of every leaf) of one mamba2 layer as m
    ranks of the "tp" layout compute it, summed as their collectives sum
    it: each rank on its own bf16 copy of x (f's input), its heads' gated
    columns (`mamba2_gated`), the sums of squares added in fp32 rank after
    rank (the gated norm's all-reduce), each rank's normed out projection
    (`mamba2_out`) added in bf16 rank after rank (g); the m gradients of
    the x copies added in bf16 the same way (f's backward), the leaves' in
    fp32, as the partial leaves' gradient sync sums them. The loss is (y *
    wt).sum()."""
    import torch
    from repro_torch.models import partitioning
    from repro_torch.models import ssm as SSM

    dt = getattr(torch, cfg.compute_dtype)
    xs = [x32.detach().to(dt).requires_grad_() for _ in range(m)]
    shares = [partitioning.mamba_share(leaves, r, m) for r in range(m)]
    gated = [SSM.mamba2_gated(shares[r], xs[r], cfg, r, m)[0] for r in range(m)]
    sq = ring([g.square().sum(dim=-1, keepdim=True) for g in gated])
    y = ring([SSM.mamba2_out(shares[r], gated[r], sq, cfg, r, m) for r in range(m)])
    grads = torch.autograd.grad((y.float() * wt).sum(), xs + list(leaves.values()))
    return y.detach().float(), [ring(grads[:m]).float(), *grads[m:]]


def mamba_share_phase() -> dict:
    """One full-width zamba2-1.2b mamba2 layer (fp32 weights from seed 7:
    matrices at std 1/sqrt(fan-in), the conv weights N(0, 1)/sqrt(d_conv),
    a_log, d_skip and dt_bias the model's init, the biases and the norm
    scale 0.3 N(0, 1) about their init) on x of MAMBA_SHARE_TOKENS: the
    TP_RANKS shares summed as the program's collectives sum them
    (`mamba_share_sums`), held against the whole `mamba2_apply` within
    BF16_TOL of its max (`held`), and so are the gradients of x and of
    every leaf; a control, the gated norm over each share's own columns
    (no sum of squares over the group), must miss y's limit. A rank's
    forward timed beside the whole layer's. Fails on a disagreement."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import partitioning
    from repro_torch.models import ssm as SSM

    cfg = get_config("zamba2-1.2b")
    m = TP_RANKS
    gen = torch.Generator(device="cuda").manual_seed(7)
    shapes = SSM.mamba2_shapes(cfg)
    leaves = {name: torch.randn(sh, generator=gen, device="cuda")
              * (sh[-2] ** -0.5 if len(sh) == 2 else 0.3) for name, sh in shapes.items()}
    heads = shapes["a_log"][0]
    with torch.no_grad():
        leaves["a_log"].copy_(torch.log(torch.linspace(1.0, 16.0, heads, device="cuda")))
        leaves["d_skip"].fill_(1.0)
        leaves["dt_bias"].add_(math.log(math.expm1(0.01)))
        leaves["gate_norm_scale"].add_(1.0)
    leaves = {name: t.requires_grad_() for name, t in leaves.items()}
    dt = getattr(torch, cfg.compute_dtype)
    x32 = torch.randn(*MAMBA_SHARE_TOKENS, cfg.d_model, generator=gen, device="cuda"
                      ).to(dt).float().requires_grad_()
    wt = torch.randn(*MAMBA_SHARE_TOKENS, cfg.d_model, generator=gen, device="cuda")
    xb = x32.to(dt)
    y = SSM.mamba2_apply(leaves, xb, cfg)[0].float()
    want = torch.autograd.grad((y * wt).sum(), [x32, *leaves.values()])
    y = y.detach()
    total, got = mamba_share_sums(cfg, leaves, x32, wt, m)
    checks = {"y": held(total, y, BF16_TOL)}
    for name, g, g_want in zip(["x", *leaves], got, want):
        checks[f"{name}_grad"] = held(g, g_want, BF16_TOL)
    del got, want, total
    with torch.no_grad():
        shares = [partitioning.mamba_share(leaves, r, m) for r in range(m)]
        gated = [SSM.mamba2_gated(shares[r], xb, cfg, r, m)[0] for r in range(m)]
        local = ring([SSM.mamba2_out(shares[r], g, g.square().sum(dim=-1, keepdim=True) * m,
                                     cfg, r, m) for r, g in enumerate(gated)])
        control = held(local.float(), y, BF16_TOL)
        del gated, local

        def one_rank():
            yf = SSM.mamba2_gated(shares[0], xb, cfg, 0, m)[0]
            SSM.mamba2_out(shares[0], yf, yf.square().sum(dim=-1, keepdim=True), cfg, 0, m)

        whole_ms = time_ms(lambda: SSM.mamba2_apply(leaves, xb, cfg))
        rank_ms = time_ms(one_rank)
    worst = max(checks, key=lambda key: checks[key][2])
    row = dict(case=f"zamba2-1.2b mamba2 layer, {m} head shares", tokens=MAMBA_SHARE_TOKENS,
               heads_a_share=heads // m, d_inner_a_share=shapes["wz"][1] // m,
               held=len(checks), sums="bf16 rank after rank; sums of squares fp32",
               ok=all(c[0] for c in checks.values()) and not control[0],
               worst=worst, worst_err_over_max=checks[worst][2],
               y_err_over_max=checks["y"][2], x_grad_err_over_max=checks["x_grad"][2],
               control_err_over_max=control[2],
               failed=[key for key, c in checks.items() if not c[0]],
               atol=BF16_TOL["atol"], rtol=BF16_TOL["rtol"], whole_ms=whole_ms,
               rank_ms=rank_ms, whole_over_rank=whole_ms / rank_ms)
    print("mamba shares " + json.dumps(row))
    print("mamba shares, each check's max |d| over max |want|: "
          + json.dumps({key: c[2] for key, c in checks.items()}))
    del leaves, x32, wt, xb, y, shares
    torch.cuda.empty_cache()
    if not row["ok"]:
        fail(f"zamba2's {m} mamba2 head shares disagree with the whole layer, or the "
             f"control does not miss: {row['failed']}")
    return row


def ssd_local_heads_phase() -> dict:
    """The SSD kernels, forward and backward, on a rank's 64 / TP_RANKS
    heads of SSD_SHAPE (bf16 x/b/c, `m2_inputs`' seed; the cotangents seed
    6) as the "tp" layout hands them over: the rank's x, dt, a and d
    contiguous, B and C of the single group whole; held against the plain
    scan and autograd of it (M2_TOL, as `mamba2_kernel_phase`), timed beside
    the whole 64-head call and their bound. Returns the rows by kernel.
    Fails on a disagreement."""
    import torch
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import ref

    b, s, h, p, n, g = SSD_SHAPE
    nh = h // TP_RANKS
    x, dt, a, bb, cc, d, _ = m2_inputs(SSD_SHAPE, "bfloat16", False, False)
    gen = torch.Generator(device="cuda").manual_seed(6)
    dy = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
    ds = torch.randn((b, h, p, n), generator=gen, device="cuda")
    loc = [x[:, :, :nh].contiguous(), dt[:, :, :nh].contiguous(), a[:nh].contiguous(), bb, cc,
           d[:nh].contiguous()]
    dy_l, ds_l = dy[:, :, :nh].contiguous(), ds[:, :nh].contiguous()
    y, state = m2.mamba2_scan(*loc)
    y_p, state_p = ref.mamba2_chunked_plain(*loc, chunk=M2_PLAIN_CHUNK)
    ok_f = wkv_ok(y, y_p, M2_TOL) and wkv_ok(state, state_p, M2_TOL)
    err_f = max(wkv_error(y, y_p)[0], wkv_error(state, state_p)[0])
    got = m2._launch_bwd(*loc, None, dy_l, ds_l)
    want = list(plain_m2_grads(*loc, None, dy_l, ds_l))
    want[2] = m2_da_f64(*loc, None, dy_l, ds_l)
    ok_b = all(u.shape == e.shape and wkv_ok(u, e, M2_TOL) for u, e in zip(got, want))
    err_b = max(wkv_error(u, e)[0] for u, e in zip(got, want))
    del y, state, y_p, state_p, got, want
    shape = (b, s, nh, p, n, g)
    rows = {}
    for name, backward in (("mamba2_scan_fwd", False), ("mamba2_scan_bwd", True)):
        if backward:
            def local():
                return m2._launch_bwd(*loc, None, dy_l, ds_l)

            def whole():
                return m2._launch_bwd(x, dt, a, bb, cc, d, None, dy, ds)

            def plain():
                return plain_m2_grads(*loc, None, dy_l, ds_l)
        else:
            def local():
                return m2.mamba2_scan(*loc)

            def whole():
                return m2.mamba2_scan(x, dt, a, bb, cc, d)

            def plain():
                return ref.mamba2_chunked_plain(*loc, chunk=M2_PLAIN_CHUNK)
        ms, whole_ms = time_ms(local), time_ms(whole)
        bound_ms, bound_by = m2_bound(shape, "bfloat16", False, backward)
        rows[name] = dict(
            kernel=name, case=f"zamba2-1.2b scan, {nh} of {h} heads (a rank's on {TP_RANKS})",
            shape=shape, dtype="bfloat16", max_abs_err=err_b if backward else err_f,
            ok=ok_b if backward else ok_f, ms=ms, whole_ms=whole_ms,
            whole_over_local=whole_ms / ms, plain_ms=time_ms(plain, 0.0), library_ms=None,
            bound_ms=bound_ms, bound_by=bound_by)
        print("mamba2 local heads " + json.dumps(rows[name]))
    del x, dt, a, bb, cc, d, dy, ds, loc, dy_l, ds_l
    torch.cuda.empty_cache()
    if not all(row["ok"] for row in rows.values()):
        fail(f"the SSD kernels on {nh} heads disagree with their plain versions")
    return rows


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

    with span("plain prefills"):
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
                err_fp32=err_fp32, requests=n_req, prompt_len=prompt_len, max_new=max_new), model


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


@spanned
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
    with span("fit"):
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
    with span("profile"):
        out["profile"] = train_profile(ex, final, pipe)
    del report, state, final
    torch.cuda.empty_cache()

    # lockstep: every SSD call of one step against its plain version
    with span("lockstep"):
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
    with span("whole"):
        out.update(scan_whole_check("zamba2", "zamba2", cfg, ZAMBA_CHECK_LAYERS,
                                    ZAMBA_CHECK_BATCH, ZAMBA_CHECK_SEQ))
    return out


# ---------------------------------------------------------------------------
# the other dense configs (gemma-2b, qwen3-8b, qwen2.5-32b) and the method
# variants (gsam, looksam, esam, aesam, mesa)
# ---------------------------------------------------------------------------

# Every config is served and trained at full width through the same two
# phases; a config's own data is its prompt shape, its stub inputs (the
# launcher's `prompt_batch`) and its flash calls a forward
# (`flash_calls_per_forward`).
SERVE_ARCHS = ("gemma-2b", "qwen3-8b", "qwen2.5-32b", "mixtral-8x7b", "deepseek-v2-lite-16b",
               "phi-3-vision-4.2b", "whisper-tiny")
TRAIN_ARCHS = ("gemma-2b", "qwen3-8b", "mixtral-8x7b", "deepseek-v2-lite-16b",
               "phi-3-vision-4.2b", "whisper-tiny")
# (requests, prompt tokens) served, 8 x 1024 unless named: mixtral's prompts
# are long enough for its 4096-token window to bind in prefill and in every
# decode step
SERVE_PROMPTS = {"mixtral-8x7b": (2, 8192)}
SERVE_NEW_TOKENS = 32
# A MoE layer's capacity C grows with the group's length, so prefill and one
# longer forward drop different routes at the config's capacity factor. The
# serve check holds prefill + decode against one forward at this factor,
# where no route is dropped, as the CPU tests do.
CHECK_CAPACITY_FACTOR = 8.0
# Serving keeps the fp32 weights and casts a layer's at use. Beside them the
# phase needs one full forward's logits (8 x 1056 x vocab in bf16, 2.6-4.3 GB),
# the fp32-compute prefills' activations and the plain attention's fp32
# scores: a config deeper than its fp32 weights plus this much is cut.
SERVE_HEADROOM_GIB = 16
# Training takes the deepest cut whose peak, extrapolated from one step at
# the two shallowest cuts, leaves this share of the card free.
TRAIN_HEADROOM = 0.10
# bf16 over 4-36 layers: each config's serving logits (prefill + decode
# against one forward, the kernel path against the plain path) are held to
# DENSE_BF16_MARGIN times bf16's own error on its weights (the plain path in
# bf16 against it in fp32, max|d| / max|ref|), as the scan families' moments
# are; the control, the kernel path with its weights at DENSE_COARSE_BITS
# significant bits, must exceed that limit. On a MoE model a router tie that
# rounds the other way moves a token by a whole expert (mixtral's decode
# against the forward: max|d| 0.99 of max|ref| at 11 layers, 32 steps), so
# the MoE models' logits are held by their bulk (median|d| / median|ref|, as
# the whole-path checks' moments) and the serve check counts the routes
# decode and the forward disagree on. On the H100
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


def model_serve_phase(arch: str) -> dict:
    """Serve `arch` (full width; full depth, or the deepest cut that fits)
    through `launch.serve.serve` with the launcher's stub inputs: the
    launches of one prefill, tokens/s and peak memory; prefill + decode
    against one forward over the same tokens (a MoE model at
    CHECK_CAPACITY_FACTOR, its routes compared too); the kernel path against
    the plain path in bf16 and in fp32 compute; the profile; then the
    coarse-weights control."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenTask
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import prompt_batch, serve
    from repro_torch.models import build_model

    n_req, prompt_len = SERVE_PROMPTS.get(arch, (8, 1024))
    max_new = SERVE_NEW_TOKENS
    full_cfg = get_config(arch)
    cfg = dataclasses.replace(full_cfg, n_layers=serve_depth(full_cfg))
    cuts = ([] if cfg.n_layers == full_cfg.n_layers else
            [f"depth {cfg.n_layers} of {full_cfg.n_layers} layers (fp32 weights + "
             f"{SERVE_HEADROOM_GIB} GiB of the card)"])
    t0 = time.perf_counter()
    with span("init"):
        model = build_model(cfg).init(seed=0, device="cuda")
        torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{arch} serve: init on the card {time.perf_counter() - t0:.3f}s, {n_params} params "
          f"({cfg.param_dtype}, {4 * n_params / 2**30:.2f} GiB; full depth "
          f"{param_count(full_cfg, full_cfg.n_layers)}), full width, cuts: {cuts or 'none'}; "
          f"{n_req} x {prompt_len} prompts + {max_new} greedy tokens, compute "
          f"{cfg.compute_dtype}, window {cfg.sliding_window}")
    prompts = TokenTask(cfg.vocab_size, seed=0).sample(n_req, prompt_len)
    with span("warm-up"):
        serve(cfg, model, prompts[:, :1024], 2)           # warm-up, not counted

    reset_launches()                                      # counts: 0 just before
    torch.cuda.reset_peak_memory_stats()
    with span("serve"):
        res = serve(cfg, model, prompts, max_new)
    launches = {"flash_attention": fa.launches}           # read just after
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = flash_calls_per_forward(cfg)
    print(f"{arch} serve: prefill {n_req}x{prompt_len} in {res.prefill_s:.4f}s "
          f"({res.prefill_tok_s:.1f} tok/s); decode {max_new - 1} steps in {res.decode_s:.4f}s "
          f"({res.decode_tok_s:.1f} tok/s); peak {peak_gib:.2f} GiB; flash launches per "
          f"prefill {launches['flash_attention']} (expected {want})")
    if launches["flash_attention"] != want:
        fail(f"{arch}: flash_attention launched {launches['flash_attention']} times in one "
             f"prefill, expected {want}")
    if res.tokens.shape != (n_req, max_new) or res.logits.shape != (n_req, max_new,
                                                                     cfg.vocab_size):
        fail(f"{arch}: unexpected output shapes {tuple(res.tokens.shape)} "
             f"{tuple(res.logits.shape)}")
    if not bool(torch.isfinite(res.logits).all()):
        fail(f"{arch}: non-finite logits")

    tokens = torch.as_tensor(prompts, device="cuda")
    moe = cfg.moe is not None
    measure = bulk_rel if moe else rel_err
    check_cfg, check, flips = cfg, res, None
    with span("forward check"), recorded_routes() as dec_routes:
        if moe:
            check_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=CHECK_CAPACITY_FACTOR))
            check = serve(check_cfg, model, prompts, max_new)
    # the prompt's stub inputs (whisper's frame count follows the prompt)
    full = {**prompt_batch(check_cfg, tokens),
            "tokens": torch.cat([tokens.long(), check.tokens[:, :-1]], dim=1)}
    with span("forward check"), torch.inference_mode(), recorded_routes() as fwd_routes:
        fwd, _ = build_model(check_cfg).forward(model, full)
    if moe:
        # prefill's routes, then each decode step's, a call per MoE layer
        n_moe = len(fwd_routes)
        steps = [dec_routes[i:i + n_moe] for i in range(0, len(dec_routes), n_moe)]
        flips = route_flips([r for step in steps for r in step],
                            [r[:, :prompt_len] for r in fwd_routes]
                            + [r[:, prompt_len - 1 + i:prompt_len + i]
                               for i in range(1, max_new) for r in fwd_routes])
        flips["tokens_of"] = n_req * (prompt_len + max_new - 1) * n_moe
    err_fwd = measure(check.logits, fwd[:, prompt_len - 1:])
    max_fwd = rel_err(check.logits, fwd[:, prompt_len - 1:])
    del fwd, full, check, dec_routes, fwd_routes
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")

    def prefill_logits(c, impl):
        ops.set_default_impl(impl)
        try:
            with torch.inference_mode():
                return build_model(c).prefill(model, prompt_batch(c, tokens))[0][:, -1]
        finally:
            ops.set_default_impl(None)

    with span("plain prefills"):
        plain16, plain32 = prefill_logits(cfg, "plain"), prefill_logits(cfg32, "plain")
        kernel32 = prefill_logits(cfg32, "kernel")
    err_plain = measure(res.logits[:, 0], plain16)
    err_fp32 = rel_err(kernel32, plain32)
    own = measure(plain16, plain32)
    limit = DENSE_BF16_MARGIN * own
    profile = profile_phase(model, cfg, n_req, prompt_len, tag=arch)
    with torch.no_grad():                                 # the control, last: it spoils
        for p in model.parameters():                      # the weights
            coarsen_(p.data, DENSE_COARSE_BITS)
    err_coarse = measure(prefill_logits(cfg, "kernel"), plain16)
    how = ("median|d|/median|ref|: a route flip moves a token by a whole expert; max|d|/max|ref| "
           f"of prefill+decode vs forward {max_fwd:.3e}; decode's routes vs the forward's "
           f"{json.dumps(flips)}" if moe else "max|d|/max|ref|")
    print(f"{arch} serve check ({how}): prefill+decode vs forward {err_fwd:.3e}"
          f"{f' (capacity factor {CHECK_CAPACITY_FACTOR})' if moe else ''}; "
          f"kernel vs plain prefill {err_plain:.3e}; both held to {DENSE_BF16_MARGIN} x bf16's "
          f"own error (bf16 plain vs fp32 plain {own:.3e}) = {limit:.3e}; fp32 compute kernel "
          f"vs plain {err_fp32:.3e} (tolerance {MODEL_FP32_REL_TOL}, max|d|/max|ref|); "
          f"control, weights at {DENSE_COARSE_BITS} bits vs plain {err_coarse:.3e} (must "
          f"exceed the limit)")
    if not (err_fwd <= limit and err_plain <= limit and err_fp32 <= MODEL_FP32_REL_TOL):
        fail(f"{arch} serving logits disagree")
    if err_coarse <= limit:
        fail(f"{arch} serve check: the coarse-weights control meets the limit")
    out = dict(arch=arch, layers=cfg.n_layers, full_layers=full_cfg.n_layers, cuts=cuts,
               params=n_params, requests=n_req, prompt_len=prompt_len, max_new=max_new,
               launches=launches, prefill_s=res.prefill_s, decode_s=res.decode_s,
               prefill_tok_s=res.prefill_tok_s, decode_tok_s=res.decode_tok_s,
               peak_gib=peak_gib, measure=measure.__name__, err_forward=err_fwd,
               err_forward_max=max_fwd, route_flips=flips,
               check_capacity_factor=CHECK_CAPACITY_FACTOR if moe else None,
               err_plain=err_plain, err_fp32=err_fp32, bf16_own=own, limit=limit,
               err_coarse=err_coarse, profile=profile)
    del model, plain16, plain32, kernel32, res
    gc.collect()
    torch.cuda.empty_cache()
    return out


@spanned
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


def shallowest_cut(cfg) -> int:
    """The fewest layers that hold every kind of block: 1, and for a config
    whose first layers are dense (deepseek) those and one MoE layer."""
    from repro_torch.models.transformer import n_dense
    return n_dense(cfg) + 1


@spanned
def train_depth(cfg) -> tuple[int, dict]:
    """The deepest cut of `cfg` whose step's peak leaves TRAIN_HEADROOM of
    the card, from one-step probes at lo = `shallowest_cut` and lo + 1
    layers, extrapolated linearly in the depth. The second probe runs only
    if lo's peak scaled by the parameter counts fits the card; else the
    depth is lo. Returns (layers, the probes)."""
    import torch
    total = torch.cuda.get_device_properties(0).total_memory
    lo = shallowest_cut(cfg)
    p_lo = probe_peak(cfg, lo)
    probes = dict(card_gib=total / 2**30, probe_layers=lo, peak_lo_gib=p_lo / 2**30)
    layers, peak = min(lo, cfg.n_layers), p_lo
    if lo < cfg.n_layers:
        upper = p_lo * param_count(cfg, lo + 1) / param_count(cfg, lo)
        if upper > total:
            probes["upper_next_gib"] = upper / 2**30
        else:
            p_next = probe_peak(cfg, lo + 1)
            probes["peak_next_gib"] = p_next / 2**30
            per_layer = max(p_next - p_lo, 1)
            layers = lo + int(((1 - TRAIN_HEADROOM) * total - p_lo) // per_layer)
            layers = max(lo, min(cfg.n_layers, layers))
            peak = p_lo + (layers - lo) * per_layer
    probes["predicted_peak_gib"] = peak / 2**30
    return layers, probes


def model_train_phase(arch: str) -> dict:
    """Train `arch` at full width and the deepest depth that fits, 6
    AsyncSAM AdamW steps through FusedExecutor + Engine: the launches
    against the count the model implies, the step time, peak memory and (on
    a MoE model) the router's aux loss, the profile of one step, then the
    lockstep check of one step at half that depth (room for the check's
    copies of w, mu and nu)."""
    import gc
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.engine import Engine, ThroughputMeter
    from repro_torch.launch.train import kernel_launches

    full_cfg = get_config(arch)
    layers, probes = train_depth(full_cfg)
    cfg = dataclasses.replace(full_cfg, n_layers=layers)
    cuts = ([] if layers == full_cfg.n_layers else
            [f"depth {layers} of {full_cfg.n_layers} layers (one step's peak leaves "
             f"{TRAIN_HEADROOM:.0%} of the card)"])
    _, ex, state, pipe = build_trainer(TRAIN_STEPS, LR, cfg=cfg)
    n_params = sum(b.numel() for b in state.params.buffers)
    print(f"{arch} train: full width, cuts: {cuts or 'none'} (probes {json.dumps(probes)}), "
          f"{n_params} params, compute {cfg.compute_dtype}, remat {cfg.remat}; batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, b' = {max(1, round(TRAIN_BATCH * ASCENT_FRACTION))}; "
          f"adamw, lr {LR}")
    meter = ThroughputMeter(tokens_per_batch=TRAIN_BATCH * TRAIN_SEQ)
    reset_launches()                                   # counts: 0 just before
    torch.cuda.reset_peak_memory_stats()
    with span("fit"):
        report = Engine(ex, pipe, [meter]).fit(state, TRAIN_STEPS)
    launches = kernel_launches("fused", cfg.family)    # read just after
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
    moe_aux = [m["moe_aux"] for m in hist]
    if (cfg.moe is not None) != all(a > 0 for a in moe_aux):
        fail(f"{arch} train: moe_aux {moe_aux} (non-zero exactly on the MoE models)")
    step_s = statistics.median(meter.step_times[2:])
    out = dict(arch=arch, layers=layers, full_layers=full_cfg.n_layers, cuts=cuts,
               params=n_params, probes=probes, steps=TRAIN_STEPS,
               step_times_s=meter.step_times, median_step_s=step_s,
               descent_tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s, peak_gib=peak_gib,
               launches=launches, flash_per_step=flash_n, moe_aux=moe_aux,
               loss_first=hist[0]["loss"], loss_last=hist[-1]["loss"])
    print(f"{arch} train: median step (steps 2-{TRAIN_STEPS - 1}) {step_s:.4f} s, "
          f"{out['descent_tokens_per_s']:.1f} descent tok/s, peak {peak_gib:.2f} GiB "
          f"(predicted {probes['predicted_peak_gib']:.2f}), moe_aux {moe_aux}")
    final = report.final_state
    out["profile"] = train_profile(ex, final, pipe, tag=f"{arch} adamw")
    del ex, state, pipe, report, final
    gc.collect()
    torch.cuda.empty_cache()

    check_layers = max(shallowest_cut(cfg), layers // 2)
    lock = lockstep_check(steps=1, cfg=dataclasses.replace(cfg, n_layers=check_layers))
    print(f"{arch} train check, lockstep (one step at {check_layers} layers, lr {LR}; each "
          f"epilogue kernel call vs its plain version on the same inputs): {json.dumps(lock)}; "
          f"tolerance rel {LOCKSTEP_REL_TOL}, one call and one launch each")
    if not all(r["calls"] == r["launches"] == 1 and r["max_rel_err"] <= LOCKSTEP_REL_TOL
               for r in lock.values()):
        fail(f"an epilogue kernel on the {arch} training path disagrees with its plain version")
    out.update(lockstep=lock, lockstep_layers=check_layers)
    return out


# Full-width olmo-1b, its depth cut to VARIANT_LAYERS of 16 layers (the run's
# time pays for the elastic phase; every check here reads a step's branch and
# its kernels, which the depth does not change), trains each variant through
# FusedExecutor + Engine as the launcher builds it (AdamW at lr 3e-3, rho
# 0.05, batch 8 x 1024), for enough steps to show its branches: LookSAM (k 2)
# fresh, reuse, fresh, reuse; AE-SAM past its 8 forced SAM steps; MESA's term
# on from step 2.
VARIANT_LAYERS = 4
VARIANT_STEPS = {"gsam": 3, "looksam": 4, "esam": 3, "aesam": 10, "mesa": 4}
VARIANT_MKW = {"looksam": {"looksam_k": 2}, "mesa": {"mesa_start_step": 2}}
WEIGHT_KERNELS = ("sq_norm", "sam_perturb", "fused_axpy", "fused_dot_norms", "adamw_epilogue")
# the methods whose every weight-space kernel call is held to its plain
# version, and over how many steps (LookSAM's: a fresh and a reuse step)
VARIANT_LOCKSTEP = {"gsam": 1, "looksam": 2}


@spanned
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


@spanned
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

    import dataclasses as dc
    from repro_torch.configs import get_config

    vcfg = dc.replace(get_config("olmo-1b"), n_layers=VARIANT_LAYERS)
    print(f"variants: olmo-1b at full width, {VARIANT_LAYERS} of "
          f"{get_config('olmo-1b').n_layers} layers")
    out = {"layers": VARIANT_LAYERS}
    for method, steps in VARIANT_STEPS.items():
        with phase(f"variant {method}"):
            mkw = VARIANT_MKW.get(method, {})
            cfg, ex, state, pipe = build_trainer(steps, LR, method=method, mkw=mkw, cfg=vcfg)
            reset_launches()                               # counts: 0 just before
            meter = ThroughputMeter(tokens_per_batch=TRAIN_BATCH * TRAIN_SEQ)
            per_step = StepLaunches()
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
            print(f"variant {method}: resident {ex.resident}; median step "
                  f"{row['median_step_s']:.4f} s (steps 1-{steps - 1}), peak {peak_gib:.2f} "
                  f"GiB, carried state {row['carried_bytes']} bytes; in the profiled step copy "
                  f"kernels "
                  f"{row['profile']['copy_us']:.1f} us, memcpys {row['profile']['memcpy_us']:.1f} "
                  f"us, host reads {row['profile']['host_read_us']:.1f} us")
            del ex, state, pipe, report, final
            gc.collect()
            torch.cuda.empty_cache()
            if method in VARIANT_LOCKSTEP:
                n = VARIANT_LOCKSTEP[method]
                lock = lockstep_check(names=WEIGHT_KERNELS, steps=n, method=method, mkw=mkw,
                                      cfg=vcfg)
                print(f"variant {method} check, lockstep ({n} step(s), lr {LR}; every weight-space "
                      f"kernel call vs its plain version on the same inputs): {json.dumps(lock)}; "
                      f"tolerance rel {LOCKSTEP_REL_TOL}")
                if not all(r["calls"] == r["launches"] and r["max_rel_err"] <= LOCKSTEP_REL_TOL
                           for r in lock.values()):
                    fail(f"a weight-space kernel on the {method} path disagrees with its plain "
                         f"version")
                row["lockstep"] = lock
            out[method] = row
    return out


# ---------------------------------------------------------------------------
# the MoE, MLA, vision-stub and encoder-decoder families (mixtral-8x7b,
# deepseek-v2-lite-16b, phi-3-vision-4.2b, whisper-tiny)
# ---------------------------------------------------------------------------

# the whole-path check on deepseek: 2 layers (the dense one and one MoE
# layer), batch 2 x 512
MOE_CHECK_ARCH, MOE_CHECK_LAYERS, MOE_CHECK_BATCH, MOE_CHECK_SEQ = (
    "deepseek-v2-lite-16b", 2, 2, 512)


def bulk_rel(a, b) -> float:
    """median |a - b| / median |b| (over every BULK_STRIDE-th element)."""
    import torch
    d = (a.float() - b.float()).abs().flatten()[::BULK_STRIDE]
    return float(torch.median(d)) / max(float(torch.median(b.float().abs().flatten()[
        ::BULK_STRIDE])), 1e-30)


@contextlib.contextmanager
def recorded_routes():
    """Yields a list that collects the experts (G, S, K) of every MoE
    layer's router call made inside the block, in call order."""
    from repro_torch.models import moe as MOE
    routes, original = [], MOE.route

    def recording(router, x, c):
        out = original(router, x, c)
        routes.append(out[2])
        return out

    MOE.route = recording
    try:
        yield routes
    finally:
        MOE.route = original


def route_flips(a, b) -> dict:
    """(token, slot) routes and tokens' expert sets that differ between two
    lists of route tensors of the same shapes."""
    slots = sum(int((x != y).sum()) for x, y in zip(a, b))
    sets = sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum()) for x, y in zip(a, b))
    return dict(slots=slots, tokens=sets)


@spanned
def route_flip_check(cfg, batch: int, seq: int) -> dict:
    """One forward of `cfg` (seed-0 weights) over a batch x seq batch on the
    kernel path in bf16, the plain path in bf16 and in fp32, and the kernel
    path with its weights at COARSE_BITS: the (token, slot) routes of every
    MoE layer that differ from the plain bf16 path's, and the logits' bulk
    error. Under bf16 a near-tie in the router can flip between two paths
    that round differently, and moves that token's output by a whole expert:
    the count is reported, and the logits are held by their bulk to
    MOMENT_BULK_MARGIN x bf16's own error; the control must exceed it."""
    import gc
    import torch
    from repro_torch.data.synthetic import TokenTask
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    model = build_model(cfg).init(seed=0, device="cuda")
    tokens = torch.as_tensor(TokenTask(cfg.vocab_size, seed=0).sample(batch, seq),
                             device="cuda")

    def run(compute, impl):
        ops.set_default_impl(impl)
        try:
            with torch.inference_mode(), recorded_routes() as routes:
                logits, _ = build_model(dataclasses.replace(cfg, compute_dtype=compute)
                                        ).forward(model, {"tokens": tokens})
        finally:
            ops.set_default_impl(None)
        return logits.float(), routes

    k16, p16, p32 = run("bfloat16", "kernel"), run("bfloat16", "plain"), run("float32", "plain")
    with torch.no_grad():
        for p in model.parameters():
            coarsen_(p.data, COARSE_BITS)
    c16 = run("bfloat16", "kernel")

    def flips(a, b) -> dict:
        return route_flips(a[1], b[1])

    n_routes = sum(x.numel() for x in p16[1])
    own = bulk_rel(p16[0], p32[0])
    out = dict(routes=n_routes, moe_layers=len(p16[1]),
               flips_kernel_vs_plain=flips(k16, p16), flips_bf16_vs_fp32=flips(p16, p32),
               flips_coarse_vs_plain=flips(c16, p16), logits_bulk=bulk_rel(k16[0], p16[0]),
               logits_bulk_own=own, logits_bulk_coarse=bulk_rel(c16[0], p16[0]),
               limit=MOMENT_BULK_MARGIN * own, logits_max_rel=rel_err(k16[0], p16[0]))
    del model, k16, p16, p32, c16
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_whole_check() -> dict:
    """deepseek at MOE_CHECK_LAYERS layers and MOE_CHECK_BATCH x
    MOE_CHECK_SEQ: the route flips of one forward (kernel vs plain path) and
    the whole training path against the plain path (`scan_whole_check`)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(MOE_CHECK_ARCH), n_layers=MOE_CHECK_LAYERS)
    with span("routes"):
        routes = route_flip_check(cfg, MOE_CHECK_BATCH, MOE_CHECK_SEQ)
    print(f"{MOE_CHECK_ARCH} route check ({MOE_CHECK_LAYERS} layers, batch {MOE_CHECK_BATCH} "
          f"x {MOE_CHECK_SEQ}, one forward; routes that differ from the plain bf16 path's, "
          f"by (token, slot) and by token's expert set; logits' bulk median|d|/median|ref|): "
          f"{json.dumps(routes)}")
    if not routes["logits_bulk"] <= routes["limit"]:
        fail(f"{MOE_CHECK_ARCH}: the kernel path's logits disagree with the plain path's")
    if routes["logits_bulk_coarse"] <= routes["limit"]:
        fail(f"{MOE_CHECK_ARCH} route check: the coarse-weights control meets the limit")
    whole = scan_whole_check(MOE_CHECK_ARCH, MOE_CHECK_ARCH, cfg, MOE_CHECK_LAYERS,
                             MOE_CHECK_BATCH, MOE_CHECK_SEQ)
    return dict(routes=routes, **whole)


def device_time_by_kernel(prof) -> dict:
    """{name: [device us, calls]} of the device-side kernels (and memcpys)
    the profiler recorded, from its raw (kineto) events: the same sums as
    its FunctionEvents (`prof.events()`, `key_averages()`), whose building
    took about ten times as long and most of a profile's host time."""
    from torch.autograd import DeviceType
    by_name: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            tot = by_name.setdefault(e.name(), [0.0, 0])
            tot[0] += e.duration_ns() / 1e3
            tot[1] += 1
    return by_name


def event_tree_by_kernel(prof) -> dict:
    """`device_time_by_kernel` read from the profiler's event tree
    (`prof.events()`, FunctionEvents), the reading the profiles used before
    the raw events: to compare the two on one profile."""
    from torch.autograd import DeviceType
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            tot = by_name.setdefault(e.name, [0.0, 0])
            tot[0] += e.time_range.elapsed_us()
            tot[1] += 1
    return by_name


def host_time_us(prof, op: str) -> float:
    """The host time of every call of `op` the profiler recorded (its raw
    events, as `device_time_by_kernel`): key_averages()'s cpu_time_total."""
    from torch.autograd import DeviceType
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CPU and e.name() == op) / 1e3


@spanned
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
    read_us = host_time_us(prof, "aten::_local_scalar_dense")
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


# ---------------------------------------------------------------------------
# dry-run phase: the train step traced on fake tensors, then production cells
# ---------------------------------------------------------------------------

# The abstract twin's predicted peak against the train phase's measured
# max_memory_allocated: the caching allocator rounds every block up (to 512
# bytes, a large one to 2 MiB) and holds cuBLAS's workspaces, which the
# trace, counting tensors' storages, does not see.
DRYRUN_PEAK_TOL = 0.10
# The mesh layout's checks. olmo-1b train_4k 16x16 computed 754.3 TFLOP
# a step on rank 0 in the data-parallel layout before this one (PERF.md, the
# dry run's records): its flops at full depth, from the 1- and 2-layer cuts
# (the layers are alike: f(16) = f(1) + 15 (f(2) - f(1))), must be at most
# an eighth of that. qwen2.5-32b train_4k 2x16x16 held every weight gathered whole at
# once, 122 GiB at full depth: at a cut of QWEN_CUT layers its peak must lie
# at least (QWEN_CUT - 1) / 63 of 100 GiB below the old layout's record at
# that cut (QWEN_OLD_PEAK: bytes, `launch.dryrun.run_cell` of the commit
# before the per-layer gathers at the same cut, whose records on the CPU
# equal the card's; the cut is 2 layers since the run neared its time limit
# on a slow host, 4 before), the share of the layers whose weights the
# per-layer gathers no longer hold together.
OLMO_OLD_TFLOP, OLMO_LAYERS = 754.3, 16
QWEN_CUT, QWEN_LAYERS, QWEN_OLD_PEAK = 2, 64, 229_509_785_148
QWEN_DROP_GIB = 100.0
# qwen2.5-32b decode_32k 16x16 gathered its whole cache on every rank (132.48
# GiB at full depth, PERF.md); under "fsdp_sp" each rank decodes over its
# sequence block of the cache: its peak at full depth, from the 1- and
# 2-layer cuts (the layers are alike), must fit one card.
CARD_BYTES = 80e9
# (arch, shape, multi-pod, layers: a depth cut, None for full depth). The
# full-depth cells of every arch are `python -m repro_torch.launch.dryrun
# --all --both-meshes`'s (PERF.md); here each cell shows that the card's path
# traces on the production mesh, at a depth that keeps the phase short.
DRYRUN_CELLS = (("olmo-1b", "train_4k", False, 1), ("olmo-1b", "train_4k", False, 2),
                ("zamba2-1.2b", "long_500k", False, None),
                ("deepseek-v2-lite-16b", "prefill_32k", False, None),
                ("qwen2.5-32b", "train_4k", True, QWEN_CUT),
                ("qwen2.5-32b", "decode_32k", False, 1), ("qwen2.5-32b", "decode_32k", False, 2))
DISPATCH_CALLS, DISPATCH_ROUNDS = 2000, 3


def host_us(fn, calls: int = DISPATCH_CALLS) -> float:
    """Host time of one call of fn, over `calls` back-to-back calls ending
    in a synchronize (tiny inputs, so the host's enqueue sets the pace)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


@spanned
def dispatch_cost() -> dict:
    """What the `torch.library` custom op adds to a launch: each op called
    through the dispatcher against its body called directly, in turns (op,
    direct, direct, op) for DISPATCH_ROUNDS rounds; medians of each."""
    import statistics
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_update as fu

    q = torch.randn(1, 128, 2, 64, device="cuda", dtype=torch.bfloat16)
    w, g = (torch.randn(4096, device="cuda") for _ in range(2))
    mu, nu = torch.zeros_like(w), torch.ones_like(w)
    scal = torch.tensor([1.0, 1e-6, 1.0, 1.0, 1.0], device="cuda")
    adam = (w, g, mu, nu, scal, 0.9, 0.999, 1e-8, 0.0)
    flash = torch.ops.repro_torch.flash_attention_fwd
    pairs = {"flash_attention": (lambda: flash(q, q, q, True, 0, 0),
                                 lambda: fa._launch_impl(q, q, q, True, 0, 0)),
             "adamw_epilogue": (lambda: torch.ops.repro_torch.adamw_epilogue(*adam),
                                lambda: fu._adamw_impl(*adam))}
    out = {}
    for name, (op, direct) in pairs.items():
        ops, directs = [], []
        for _ in range(DISPATCH_ROUNDS):
            ops.append(host_us(op))
            directs += [host_us(direct), host_us(direct)]
            ops.append(host_us(op))
        out[name] = dict(op_us=statistics.median(ops), direct_us=statistics.median(directs),
                         cost_us=statistics.median(ops) - statistics.median(directs))
    return out


def dryrun_cells() -> tuple[list, float, float]:
    """`launch.dryrun.run_cell` on the card's path for DRYRUN_CELLS, each
    record printed, and the mesh layout's two checks (olmo-1b's flops at
    full depth from its two cuts, qwen2.5-32b's peak at its cut). Returns
    (the records, olmo-1b's full-depth flops, qwen2.5-32b's peak bytes)."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    cells, olmo_flops, decode_peak = [], {}, {}
    for arch, shape, multi_pod, layers in DRYRUN_CELLS:
        full = get_config(arch)
        cut = dc.replace(full, n_layers=layers) if layers else None
        tag = f"layers {layers} of {full.n_layers}" if layers else ""
        r = dryrun.run_cell(arch, shape, multi_pod=multi_pod, device="cuda", save=False,
                            verbose=False, cfg_override=cut, tag=tag)
        print("dryrun cell " + json.dumps(r.to_json()))
        if r.status != "ok":
            fail(f"dry run: {arch} x {shape} x {r.mesh}: {r.status} {r.note}")
        cells.append(r.to_json())
        if arch == "olmo-1b":
            olmo_flops[layers] = r.flops
        if arch == "qwen2.5-32b" and shape == "train_4k":
            qwen_peak = r.peak_memory_per_device
        if arch == "qwen2.5-32b" and shape == "decode_32k":
            decode_peak[layers] = r.peak_memory_per_device
    full_flops = olmo_flops[1] + (OLMO_LAYERS - 1) * (olmo_flops[2] - olmo_flops[1])
    limit = OLMO_OLD_TFLOP * 1e12 / 8
    print(f"dry run: olmo-1b train_4k 16x16 rank 0 {full_flops / 1e12:.4f} TFLOP a step at "
          f"full depth (from the 1- and 2-layer cuts {olmo_flops[1]:.6e}, "
          f"{olmo_flops[2]:.6e}), limit an eighth of {OLMO_OLD_TFLOP}: {limit / 1e12:.4f}")
    if full_flops > limit:
        fail(f"dry run: olmo-1b train_4k rank 0 computes {full_flops / 1e12:.4f} TFLOP a "
             f"step, over an eighth of the data-parallel layout's {OLMO_OLD_TFLOP}")
    drop = QWEN_DROP_GIB * (QWEN_CUT - 1) / (QWEN_LAYERS - 1)
    print(f"dry run: qwen2.5-32b train_4k 2x16x16 at {QWEN_CUT} layers: peak "
          f"{qwen_peak / 2**30:.4f} GiB, the old layout's {QWEN_OLD_PEAK / 2**30:.4f} GiB "
          f"(drop {(QWEN_OLD_PEAK - qwen_peak) / 2**30:.4f}, at least {drop:.4f})")
    if QWEN_OLD_PEAK - qwen_peak < drop * 2**30:
        fail(f"dry run: qwen2.5-32b train_4k 2x16x16 at {QWEN_CUT} layers peaks at "
             f"{qwen_peak / 2**30:.4f} GiB, less than {drop:.4f} GiB below the old "
             f"layout's {QWEN_OLD_PEAK / 2**30:.4f}")
    full_peak = decode_peak[1] + (QWEN_LAYERS - 1) * (decode_peak[2] - decode_peak[1])
    print(f"dry run: qwen2.5-32b decode_32k 16x16 rank 0 peak {full_peak / 2**30:.4f} GiB at "
          f"full depth (from the 1- and 2-layer cuts {decode_peak[1]:.6e}, "
          f"{decode_peak[2]:.6e} bytes), limit one card's {CARD_BYTES / 2**30:.4f} GiB")
    if full_peak > CARD_BYTES:
        fail(f"dry run: qwen2.5-32b decode_32k 16x16 peaks at {full_peak / 2**30:.4f} GiB "
             f"at full depth, past one card's {CARD_BYTES / 2**30:.4f}")
    return cells, full_flops, qwen_peak


def dryrun_phase(trained: dict) -> dict:
    """(a) The abstract twin of the AdamW train phase: the same executor,
    its state from `abstract_state` and the batch from `batch_spec`, fake
    tensors on the card, one step traced (`FusedExecutor.lower`): the traced
    kernels equal the train phase's launches a step, the predicted peak is
    within DRYRUN_PEAK_TOL of its max_memory_allocated, and the traces
    allocate nothing on the card (memory_allocated and, after a reset,
    max_memory_allocated unchanged). (b) `dryrun_cells`: the production
    cells and the mesh layout's checks. (c) the custom ops' dispatch cost."""
    import torch
    from repro_torch.models import batch_spec
    from repro_torch.models.config import ShapeSpec
    from repro_torch.utils import abstract

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()

    cfg, bundle, ex = train_executor(TRAIN_STEPS, LR)
    state = ex.abstract_state(lambda: bundle.init(seed=0, device="cuda"), seed=1)
    with abstract.fake_mode_of(state):
        batch = batch_spec(cfg, ShapeSpec("train", "train", TRAIN_SEQ, TRAIN_BATCH),
                           ascent_fraction=ASCENT_FRACTION, device="cuda")
    lowered = ex.lower(state, batch)
    twin_s = time.perf_counter() - t0
    want = {("flash_attention_fwd" if k == "flash_attention" else k): n // TRAIN_STEPS
            for k, n in trained["launches"].items() if n}
    if lowered.kernels != want:
        fail(f"dry run: the traced step's kernels {lowered.kernels} are not the train "
             f"phase's launches a step {want}")
    predicted_gib = lowered.peak_bytes / 2**30
    rel = abs(predicted_gib - trained["peak_gib"]) / trained["peak_gib"]
    tflops = lowered.flops / trained["median_step_s"] / 1e12
    print(f"dry run: olmo-1b AdamW step traced in {twin_s:.2f}s: kernels {lowered.kernels}; "
          f"predicted peak {predicted_gib:.4f} GiB (arguments "
          f"{lowered.argument_bytes / 2**30:.4f}), measured {trained['peak_gib']:.4f} GiB "
          f"(|d| {rel:.4f}, limit {DRYRUN_PEAK_TOL}); {lowered.flops:.6e} flops a step, "
          f"{tflops:.2f} TFLOP/s achieved at the median step {trained['median_step_s']:.4f} s "
          f"({nvidia_smi()})")
    if rel > DRYRUN_PEAK_TOL:
        fail(f"dry run: predicted peak {predicted_gib:.4f} GiB is {rel:.4f} from the "
             f"measured {trained['peak_gib']:.4f} GiB (limit {DRYRUN_PEAK_TOL})")
    del state, batch, ex

    with span("cells"):
        cells, full_flops, qwen_peak = dryrun_cells()
    torch.cuda.synchronize()
    after, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
    print(f"dry run: memory_allocated {before} before the traces, {after} after; "
          f"max_memory_allocated since the reset {peak}")
    if after != before or peak != before:
        fail(f"dry run: the traces allocated on the card (memory_allocated {before} -> "
             f"{after}, max {peak})")
    with span("dispatch"):
        cost = dispatch_cost()
    print(f"dry run: custom-op dispatch {json.dumps(cost)}; flash x 64 a step "
          f"{64 * cost['flash_attention']['cost_us']:.1f} us ({nvidia_smi()})")
    return dict(twin_s=twin_s, kernels=lowered.kernels,
                predicted_peak_gib=predicted_gib, measured_peak_gib=trained["peak_gib"],
                peak_rel=rel, flops=lowered.flops, tflops=tflops, cells=cells,
                olmo_full_flops=full_flops, qwen_peak=qwen_peak, dispatch=cost)


def main() -> int:
    t_run = time.perf_counter()
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

    with span("build"):
        libs = build.build([fa.SOURCE, sp.SOURCE, fu.SOURCE, r6.SOURCE, m2.SOURCE])
    print(f"build: {len(libs)} kernel source(s) in {SPANS['build']:.2f}s")
    for src, lib in libs.items():
        log = lib.with_name(lib.name + ".log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {src.name}: {line.strip()}")

    with phase("epilogue"):
        epilogue = epilogue_phase()
    with phase("flash"):
        flash = flash_phase()
    for name, fn in (("flash offset", offset_flash_phase), ("expert share", expert_share_phase),
                     ("moe block", moe_block_phase), ("block decode", block_decode_phase)):
        with phase(name):
            fn()
    with phase("serve"):
        served, model = serve_phase()
        print("serve " + json.dumps(served))
        profile_phase(model)
        del model
        torch.cuda.empty_cache()

    with phase("train"):
        trained, ex, state, pipe = train_phase()
        print("train " + json.dumps(trained))
        train_profile(ex, state, pipe)
        del ex, state, pipe
        torch.cuda.empty_cache()
    with phase("train check"):
        print("train check " + json.dumps(train_check()))
    with phase("guard"):
        guarded = guard_phase(trained["median_step_s"])
        print("guard " + json.dumps(guarded))

    with phase("train sgd"):
        sgd_trained, ex, state, pipe = train_phase("sgd")
        print("train sgd " + json.dumps(sgd_trained))
        train_profile(ex, state, pipe, "sgd")
        del ex, state, pipe
        torch.cuda.empty_cache()
    with phase("sgd check"):
        sgd_check()
    with phase("restart"):
        restarted = restart_phase()
    with phase("elastic"):
        elastic = elastic_phase()
    with phase("dryrun"):
        dryrun_phase(trained)

    with phase("delta kernel"):
        delta = delta_phase()
    # the remote phase's server imports this file for its loss
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    with phase("remote"):
        remote = remote_phase()
    with phase("hetero"):
        hetero_phase()
    with phase("examples"):
        examples = examples_phase()

    with phase("rwkv kernel"):
        wkv = rwkv_kernel_phase()
    for name, fn in (("rwkv local heads", rwkv_local_heads_phase),
                     ("rwkv share", rwkv_share_phase),
                     ("rwkv column share", rwkv_column_share_phase),
                     ("rwkv chain", rwkv_chain_phase)):
        with phase(name):
            fn()
    with phase("rwkv serve"):
        rwkv_served, model = rwkv_serve_phase()
        print("rwkv serve " + json.dumps(rwkv_served))
        profile_phase(model, compare_readings=True)
        del model
        torch.cuda.empty_cache()
    with phase("rwkv train"):
        rwkv_trained = rwkv_train_phase()
        print("rwkv train " + json.dumps(rwkv_trained))

    with phase("mamba2 kernel"):
        ssd = mamba2_kernel_phase()
    for name, fn in (("chained scan", chained_scan_phase), ("mamba share", mamba_share_phase),
                     ("ssd local heads", ssd_local_heads_phase)):
        with phase(name):
            fn()
    with phase("zamba2 serve"):
        zamba_served, model = zamba_serve_phase()
        print("zamba2 serve " + json.dumps(zamba_served))
        profile_phase(model)
        del model
        torch.cuda.empty_cache()
    with phase("zamba2 train"):
        zamba_trained = zamba_train_phase()
        print("zamba2 train " + json.dumps(zamba_trained))

    arch_served, arch_trained = {}, {}
    for arch in SERVE_ARCHS:
        with phase(f"{arch} serve"):
            arch_served[arch] = model_serve_phase(arch)
            print(f"{arch} serve " + json.dumps(arch_served[arch]))
    for arch in TRAIN_ARCHS:
        with phase(f"{arch} train"):
            arch_trained[arch] = model_train_phase(arch)
            print(f"{arch} train " + json.dumps(arch_trained[arch]))
    with phase("variants"):
        variants = variants_phase()
        print("variants " + json.dumps(variants))
    with phase(f"{MOE_CHECK_ARCH} whole-path check"):
        moe_whole_check()
    # the launches of these paths, each counted from 0 just before it
    new_paths = ([r["launches"] for r in arch_served.values()]
                 + [r["launches"] for r in arch_trained.values()]
                 + [variants[m]["launches"] for m in VARIANT_STEPS] + [guarded["launches"]]
                 + [elastic["launches"]]
                 + [examples[name]["launches"] for name in ("quickstart", "hetero_async_sam")])

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
    # phase (the delta kernels), every config's train phase and the variants
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
    print("spans " + json.dumps(SPANS))
    print(f"whole run: {time.perf_counter() - t_run:.1f}s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
