"""Prefill traffic: one client in a closed loop, each call a batch of
prompts of one length through the program's serving entry
(`launch.serve.serve`, whose times end in a synchronize), the next call
when the last has returned its first tokens.

Each batch takes its prompt length S from `lengths`, in cycles that hold
each length `per_cycle` times in an order drawn from the seed (so every
seed serves the same mix), and B = token_budget / S prompts of uniform
tokens made from (seed, batch). Set-up makes the weights from the seed and
serves one batch of each length. A batch's latency is its call's time,
from the call to its `max_new` tokens (with max_new 1, the first token).

The check: once the window has closed, a sample drawn from the seed of
`check_per_length` served requests of each length (the longest among
them), the program freed, the reference's logits at each sampled prompt's
last position, `ref_tokens` prompt tokens at a time; the number compared is
the widest gap by which a served token's reference logit lies below the
reference's best.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench import flops, harness, trace, weights
from bench.reference import models

WARM_INDEX = 1 << 40          # prompt rows of the warm-up, apart from the window's


def schedule(seed: int, traffic: dict, n: int) -> list[int]:
    """The prompt lengths of the first n batches."""
    cycle = [s for s, k in zip(traffic["lengths"], traffic["per_cycle"]) for _ in range(k)]
    out: list[int] = []
    c = 0
    while len(out) < n:
        rng = np.random.default_rng(np.random.SeedSequence([seed % 2**63, weights.SAMPLE, c]))
        out.extend(cycle[j] for j in rng.permutation(len(cycle)))
        c += 1
    return out[:n]


def prompts(seed: int, traffic: dict, index: int, seq: int, vocab: int, device) -> torch.Tensor:
    rows = traffic["token_budget"] // seq
    return weights.token_rows(seed, weights.PROMPTS, index, rows, seq, vocab, device)["tokens"]


def serve_window(ctx: harness.Context, port_cfg, model, seconds: float, traced: bool) -> dict:
    """Serve batches for `seconds`: {"lat", "seq", "served", "t0", "t1",
    "profile", "traced"}; served[i] is batch i's first tokens (B,)."""
    from repro_torch.launch.serve import serve
    t = ctx.traffic
    vocab = port_cfg.vocab_size
    plan = schedule(ctx.seed, t, 1 << 16)
    first, stop = t["trace_batches"]
    prof = trace.Profile() if traced else None
    out = {"lat": [], "seq": [], "served": [], "profile": prof, "traced": []}
    t0 = time.perf_counter()
    i = 0
    while True:
        if time.perf_counter() - t0 >= seconds:
            break
        if prof is not None and i == first:
            prof.start()
        if prof is not None and i == stop and prof.active:
            prof.stop()
            prof = None
        seq = plan[i]
        p = prompts(ctx.seed, t, i, seq, vocab, ctx.device)
        ts = time.perf_counter()
        res = serve(port_cfg, model, p, t["max_new"])
        out["lat"].append(time.perf_counter() - ts)
        out["seq"].append(seq)
        out["served"].append(res.tokens[:, 0])
        if prof is not None and prof.active:
            out["traced"].append((p.shape[0], seq))
        i += 1
    out["t1"] = time.perf_counter()
    out["t0"] = t0
    if prof is not None and prof.active:
        prof.stop()
    return out


def sample(seed: int, traffic: dict, seqs: list[int]) -> list[tuple[int, int]]:
    """(batch, row) pairs of served requests to check: `check_per_length`
    of each length, drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**63, weights.SAMPLE, 1 << 20]))
    picked = []
    for length in traffic["lengths"]:
        pairs = [(i, r) for i, s in enumerate(seqs) if s == length
                 for r in range(traffic["token_budget"] // s)]
        k = min(len(pairs), traffic["check_per_length"])
        picked += [pairs[j] for j in sorted(rng.choice(len(pairs), size=k, replace=False))]
    return picked


def reference_logits(ctx: harness.Context, seqs: list[int], picked: list[tuple[int, int]],
                     mms: dict) -> dict[str, torch.Tensor]:
    """{name: (len(picked), V) last-position logits of the picked prompts}
    for each matrix product of `mms` (fp32 with TF32 off, or the control's),
    the weights made again from the seed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = ctx.traffic
    _, w = weights.make_weights(ctx.cfg, ctx.seed, ctx.device)
    out = {name: [None] * len(picked) for name in mms}
    by_len: dict[int, list[int]] = {}
    for k, (i, _) in enumerate(picked):
        by_len.setdefault(seqs[i], []).append(k)
    rows_cache: dict[int, torch.Tensor] = {}
    with torch.no_grad():
        for seq, ks in by_len.items():
            block = max(1, t["ref_tokens"] // seq)
            for lo in range(0, len(ks), block):
                part = ks[lo:lo + block]
                rows = []
                for k in part:
                    i, r = picked[k]
                    if i not in rows_cache:
                        rows_cache.clear()
                        rows_cache[i] = prompts(ctx.seed, t, i, seq, ctx.cfg["vocab_size"],
                                                ctx.device)
                    rows.append(rows_cache[i][r])
                tok = torch.stack(rows)
                for name, mm in mms.items():
                    lg = models.logits(w, tok, ctx.cfg, mm, last_only=True).float()
                    for j, k in enumerate(part):
                        out[name][k] = lg[j]
    return {name: torch.stack(v) for name, v in out.items()}


def widest_gap(ref: torch.Tensor, tokens: torch.Tensor) -> float:
    """max over rows of (the reference's best logit - its logit of the
    token)."""
    got = torch.gather(ref, 1, tokens.long()[:, None])[:, 0]
    return float((ref.max(dim=1).values - got).max())


def build(ctx: harness.Context, port_cfg):
    """The program's model, weights from the seed, and one warm call of
    each length."""
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer
    model = transformer.Transformer(port_cfg, ctx.device)
    flat, views = weights.make_weights(ctx.cfg, ctx.seed, ctx.device)
    weights.load_into(model, views)
    del flat, views
    for j, seq in enumerate(ctx.traffic["lengths"]):
        serve(port_cfg, model, prompts(ctx.seed, ctx.traffic, WARM_INDEX + j, seq,
                                       port_cfg.vocab_size, ctx.device),
              ctx.traffic["max_new"])
    return model


def run(ctx: harness.Context) -> harness.Outcome:
    port_cfg = harness.port_config(ctx.cfg)
    model = build(ctx, port_cfg)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t_start
    w = serve_window(ctx, port_cfg, model, ctx.seconds, ctx.trace)
    elapsed = w["t1"] - w["t0"]
    budget = ctx.traffic["token_budget"]
    tokens = sum((budget // s) * s for s in w["seq"])
    peak = torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" else 0
    tr = None
    if w["traced"]:
        tr = trace.read(w["profile"].prof.profiler.kineto_results.events())
    served = w["served"]
    picked = sample(ctx.seed, ctx.traffic, w["seq"])
    tokens_picked = torch.stack([served[i][r] for i, r in picked]).cpu()
    requests = sum(budget // s for s in w["seq"])
    del model, w["served"]
    harness.free_cuda()
    ref = reference_logits(ctx, w["seq"], picked, {"fp32": models.fp32_mm})["fp32"]
    gap = widest_gap(ref.cpu(), tokens_picked)
    return harness.Outcome(
        metrics={"prefill_tokens_per_s": tokens / elapsed,
                 "prefill_ms_p95": 1e3 * harness.quantile(w["lat"], 0.95),
                 "setup_s": setup_s},
        attempted=requests, failed=0,
        checks=[harness.Check("logit_gap", gap, ctx.limits["logit_gap"])],
        memory_peak_bytes=peak, trace=tr,
        traced_flops=sum(flops.prefill_flops(ctx.cfg, b, s) for b, s in w["traced"]),
        notes=[f"window: {len(w['seq'])} batches, {requests} requests in {elapsed:.6f} s; "
               f"checked {len(picked)} served tokens"])
