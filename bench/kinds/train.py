"""Training traffic: a closed loop of training steps, one after another,
through the program's own entry (`engine.Engine.fit` driving
`engine.FusedExecutor.step`, which ends each step in a synchronize).

Set-up makes the weights from the seed, builds the executor and its state
once, and runs the traffic's `check_steps` steps through the same engine
and feed as the window (they build and warm every kernel). Those steps are
the ones the check follows: each one's loss, the leaf norms of the first
step's gradient as the optimizer got it (read from its state), the first
ascent gradient the method holds in its state
(its leaf norms and global norm), the perturbation of the second step
(`LossProbe`), and the leaf norms of the change of the weights after the
last. The same executor and state then run the window.
After it, with the program freed, the plain reference makes the weights
again from the seed and runs the same steps on the same rows
(`reference.train.readings`).

Traffic keys: rows, seq (the descent batch), method {name, and the
method's own: rho, ascent_rows}, optimizer {name, and the optimizer's own:
lr, b1, b2, eps, weight_decay, total_steps}, check_steps, trace_steps
[first, stop) of the window, ref_rows (rows the reference runs at a time),
and metric, the name of the rate it reports (train_tokens_per_s where it
is left out). The method's module is `reference/methods/<name>.py`; the
optimizer's are `optimizers/<name>.py` (the program's) and
`reference/optimizers/<name>.py`.
"""
from __future__ import annotations

import importlib
import math
import time

import torch

from bench import flops, harness, trace, weights
from bench.reference import models
from bench.reference import train as ref_train


class Feed:
    """The batches, made on the device from (seed, step), every step's rows
    new. Outside a window it yields for as long as it is asked; in a window
    (`open_window`) it stops asking for work once `seconds` have passed
    since its first batch, and runs the profiler over the steps
    [trace_steps[0], trace_steps[1]) when tracing."""

    def __init__(self, seed: int, traffic: dict, vocab: int, device):
        self.seed, self.traffic, self.vocab, self.device = seed, traffic, vocab, device
        self.next = 0
        self.window = None

    def batch(self, i: int) -> dict:
        t = self.traffic
        b = weights.token_rows(self.seed, weights.DESCENT, i, t["rows"], t["seq"], self.vocab,
                               self.device)
        asc = t["method"].get("ascent_rows", 0)
        if asc:
            b["ascent"] = weights.token_rows(self.seed, weights.ASCENT, i, asc, t["seq"],
                                             self.vocab, self.device)
        return b

    def open_window(self, seconds: float, traced: bool) -> None:
        self.window = {"seconds": seconds, "t0": None, "t1": None, "steps": 0,
                       "profile": trace.Profile() if traced else None, "traced": 0}

    def _close_profile(self, w: dict) -> None:
        p = w["profile"]
        if p is not None and p.active and w["traced"] == 0:
            p.stop()
            w["traced"] = w["steps"] - self.traffic["trace_steps"][0]

    def __iter__(self):
        while True:
            w = self.window
            if w is not None:
                now = time.perf_counter()
                if w["t0"] is None:
                    w["t0"] = now
                elif now - w["t0"] >= w["seconds"]:
                    self._close_profile(w)
                    w["t1"] = now
                    return
                first, stop = self.traffic["trace_steps"]
                if w["profile"] is not None:
                    if w["steps"] == first:
                        w["profile"].start()
                    elif w["steps"] == stop:
                        self._close_profile(w)
                w["steps"] += 1
            i = self.next
            self.next += 1
            yield self.batch(i)


class LossProbe:
    """The program's loss function, passed through. In the second check
    step it reads, leaf by leaf, how far the weights of the step's last
    loss call lie from its first's while both are live: for AsyncSAM the
    descent pass at w_hat against the ascent pass at w, the perturbation
    as the program applied it. A step of one loss call reads nothing."""

    def __init__(self, loss_fn):
        self.loss_fn = loss_fn
        self.armed = False
        self.first = None
        self.reading = None

    def __call__(self, params, batch, gen=None):
        if self.armed:
            if self.first is None:
                self.first = params
            else:
                with torch.no_grad():
                    self.reading = {k: float(torch.linalg.vector_norm(
                        (params[k].detach() - self.first[k].detach()).double()))
                        for k in self.first}
        return self.loss_fn(params, batch, gen)

    def disarm(self) -> None:
        self.armed, self.first = False, None


class Readings:
    """An engine callback that keeps what the check compares from the
    check steps (see the module's docstring)."""

    def __init__(self, ctx: harness.Context, probe: LossProbe):
        self.ctx = ctx
        self.probe = probe
        self.opt = optimizer(ctx.traffic)
        self.out = {"loss": [], "grad": None, "change": None}

    def on_fit_start(self, engine, state):
        pass

    def on_fit_end(self, engine, report):
        pass

    def on_step(self, engine, state, metrics, dt):
        n = self.ctx.traffic["check_steps"]
        k = len(self.out["loss"])
        if k >= n:
            return
        self.out["loss"].append(float(metrics["loss"]))
        if k == 0:
            self.out["grad"] = self.opt.first_grad_norms(state.opt_state,
                                                         self.ctx.traffic["optimizer"])
            self.probe.armed = True             # over the second step's loss calls
        elif k == 1:
            self.probe.disarm()
            if self.probe.reading is not None:
                self.out["perturbation"] = self.probe.reading
        ms = state.method_state
        if k == 0 and hasattr(ms, "ascent_grad"):
            self.out["ascent"] = _norms(_tree(ms.ascent_grad))
            self.out["ascent_norm"] = float(ms.ascent_norm)
        if k + 1 == n:
            _, w0 = weights.make_weights(self.ctx.cfg, self.ctx.seed, self.ctx.device)
            w = _tree(state.params)
            with torch.no_grad():
                self.out["change"] = {k: float(torch.linalg.vector_norm(
                    (w[k].float() - w0[k]).double())) for k in w0}
            del w0


def _tree(t) -> dict:
    return t.to_tree() if hasattr(t, "to_tree") else dict(t)


def _norms(tree: dict) -> dict[str, float]:
    vals = torch.stack([torch.linalg.vector_norm(v.double()) for v in tree.values()])
    return dict(zip(tree, vals.tolist()))


def optimizer(traffic: dict):
    """The module of the traffic's optimizer as the program builds it
    (`bench/optimizers/<name>.py`)."""
    return importlib.import_module(f"bench.optimizers.{traffic['optimizer']['name']}")


def build(ctx: harness.Context, port_cfg):
    """(engine, state, feed, readings) of the program, its weights made
    from the seed, its check steps run."""
    from repro_torch.core import MethodConfig
    from repro_torch.engine import Engine, FusedExecutor
    from repro_torch.models import build_model, transformer

    t = ctx.traffic
    model = transformer.Transformer(port_cfg, ctx.device)
    flat, views = weights.make_weights(ctx.cfg, ctx.seed, ctx.device)
    weights.load_into(model, views)
    del flat, views
    m = t["method"]
    mcfg = MethodConfig(name=m["name"], rho=m.get("rho", 0.0),
                        ascent_fraction=m.get("ascent_rows", 0) / t["rows"])
    probe = LossProbe(build_model(port_cfg).loss_fn)
    executor = FusedExecutor(probe, mcfg, optimizer(t).build(t["optimizer"]))
    state = executor.init_state(model, ctx.seed)
    del model
    feed = Feed(ctx.seed, t, port_cfg.vocab_size, ctx.device)
    readings = Readings(ctx, probe)
    engine = Engine(executor, feed, [readings])
    state = engine.fit(state, t["check_steps"]).final_state
    return engine, state, feed, readings.out


def reference(ctx: harness.Context, mm=models.fp32_mm, method: dict | None = None,
              **fault) -> dict:
    """The reference's readings of the check steps, from the seed's weights
    and rows, products in fp32 (TF32 off) unless `mm` says otherwise, the
    traffic's method unless `method` says otherwise; `fault`:
    `reference.train.readings`'s keep or update."""
    t = ctx.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    feed = Feed(ctx.seed, t, ctx.cfg["vocab_size"], ctx.device)
    batches = [feed.batch(i) for i in range(t["check_steps"])]
    _, w0 = weights.make_weights(ctx.cfg, ctx.seed, ctx.device)
    return ref_train.readings(w0, batches, ctx.cfg, t["optimizer"], method or t["method"], mm,
                              rows=t["ref_rows"], **fault)


def run(ctx: harness.Context) -> harness.Outcome:
    port_cfg = harness.port_config(ctx.cfg)
    engine, state, feed, prog = build(ctx, port_cfg)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t_start
    feed.open_window(ctx.seconds, ctx.trace)
    report = engine.fit(state, 1 << 62)
    w = feed.window
    steps = w["steps"]
    tokens = steps * ctx.traffic["rows"] * ctx.traffic["seq"]
    elapsed = w["t1"] - w["t0"]
    failed = sum(not math.isfinite(h.get("loss", math.nan)) for h in report.metrics_history)
    peak = torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" else 0
    tr = None
    if w["profile"] is not None and w["traced"]:
        tr = trace.read(w["profile"].prof.profiler.kineto_results.events())
    traced = w["traced"]
    engine.close()
    del engine, state, report, feed
    harness.free_cuda()
    ref = reference(ctx)
    checks = harness.train_checks(prog, ref, ctx.limits)
    return harness.Outcome(
        metrics={ctx.traffic.get("metric", "train_tokens_per_s"): tokens / elapsed,
                 "setup_s": setup_s},
        attempted=steps, failed=failed, checks=checks, memory_peak_bytes=peak, trace=tr,
        traced_flops=traced * flops.train_step_flops(ctx.cfg, ctx.traffic),
        notes=[f"window: {steps} steps in {elapsed:.6f} s; check losses program "
               f"{prog['loss']} reference {ref['loss']}"])
