"""The paper's headline demo: hide SAM's perturbation cost on a heterogeneous
system (a fast descent lane and a slow ascent lane), Table 4.2's mechanics.
On an H100 host the scheme is literal: the descent lane runs on the card and
the ascent lane on the host's CPU. The synchronous baselines and the
two-lane runs drive the same `Engine.fit`; only the executor differs.

    PYTHONPATH=src python -m repro_torch.examples.hetero_async_sam [--device cpu]

With `--device cpu` both lanes share the CPU's cores, so the ascent shows
up as ~(1 + b'/b)x instead of being hidden.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import optim
from repro_torch.core import MethodConfig, slice_ascent_batch
from repro_torch.data.synthetic import ClassificationTask
from repro_torch.engine import Engine, FusedExecutor, HeteroExecutor, ThroughputMeter
from repro_torch.launch.serve import resolve_device
from repro_torch.runtime import ExecutorConfig
from repro_torch.service.testing import mlp_init, mlp_loss
from repro_torch.utils.buckets import tree_view

TASK = ClassificationTask(seed=7, margin=1.05)
STEPS, BATCH = 60, 1024
WIDTHS = (64, 1024, 1024, 1024, 10)   # big enough that compute >> queue overhead


def accuracy(params, batch) -> float:
    with torch.no_grad():
        logits = mlp_loss(params, batch)[1]["logits"]
    return float(torch.mean((torch.argmax(logits, -1) == batch["y"]).float()))


def _fit(executor, batches, device, steps, widths) -> dict:
    state = executor.init_state(mlp_init(0, widths, device=device), 1)
    meter = ThroughputMeter()
    with Engine(executor, batches, [meter]) as eng:
        report = eng.fit(state, steps, warmup=1)   # build and first calls outside the timer
    return {"time_s": sum(meter.step_times),
            "acc": accuracy(tree_view(report.final_state.params), TASK.valid_set(device=device)),
            "final_loss": float(report.metrics_history[-1]["loss"])}


def run_sync(method_name, device, frac=1.0, *, steps=STEPS, batch=BATCH, widths=WIDTHS):
    mcfg = MethodConfig(name=method_name, rho=0.05, ascent_fraction=frac,
                        same_batch_ascent=True)
    opt = optim.sgd(0.05, momentum=0.9)
    batches = list(TASK.train_batches(batch, steps, device=device))
    return _fit(FusedExecutor(mlp_loss, mcfg, opt), batches, device, steps, widths)


def run_hetero(delay_s, frac, device, *, steps=STEPS, batch=BATCH, widths=WIDTHS):
    """The ascent lane on the CPU, the descent on `device`; a slower helper
    can be emulated with an injected delay a call."""
    mcfg = MethodConfig(name="async_sam", rho=0.05, ascent_fraction=frac)
    opt = optim.sgd(0.05, momentum=0.9)
    batches = [{**b, "ascent": slice_ascent_batch(b, frac)}
               for b in TASK.train_batches(batch, steps, device=device)]
    ex = HeteroExecutor(mlp_loss, mcfg, opt,
                        exec_cfg=ExecutorConfig(ascent_delay_s=delay_s, ascent_device="cpu",
                                                descent_device=device))
    out = _fit(ex, batches, device, steps, widths)
    return {**out, "ledger": ex.ledger.summary()}


def main(argv=None, *, steps: int = STEPS, batch: int = BATCH, widths=WIDTHS) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the descent lane's device: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    size = dict(steps=steps, batch=batch, widths=widths)

    sgd = run_sync("sgd", device, **size)
    sam = run_sync("sam", device, **size)
    print(f"SGD  : {sgd['time_s']:6.2f}s  acc={sgd['acc']:.4f}")
    print(f"SAM  : {sam['time_s']:6.2f}s  acc={sam['acc']:.4f}   <- 2x gradient cost")
    out = {"sgd": sgd, "sam": sam}
    for ratio in (2, 4):
        r = run_hetero(0.0, 1.0 / ratio, device, **size)
        print(f"AsyncSAM b/b'={ratio}x: {r['time_s']:6.2f}s  acc={r['acc']:.4f}  "
              f"tau={r['ledger']['tau']} refreshes={r['ledger']['refreshes']}")
        out[f"async_sam_{ratio}x"] = r
    if device.type == "cuda":
        print("-> the ascent runs on the host's CPU beside the card's descent: the")
        print("   more of it the descent hides, the nearer AsyncSAM's wall clock is")
        print("   to SGD's (paper Table 4.2).")
    else:
        print("-> both lanes share this CPU's cores, so the ascent shows up as")
        print("   ~(1 + b'/b)x instead of being hidden; with the descent on a GPU")
        print("   the helper runs on otherwise idle silicon (paper Table 4.2).")
    return out


if __name__ == "__main__":
    main()
