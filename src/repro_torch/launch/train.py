"""Training launcher (counterpart of `repro.launch.train --executor fused`).

Builds the model, the method and the optimizer as the reference does, and
runs `FusedExecutor` under `Engine.fit`: on the card by default, where the
perturbation, the optimizer epilogue, the ascent refresh and attention go
through the Hopper kernels; on the CPU with `--device cpu`, through their
plain versions. With `--ckpt-dir` the loop checkpoints every `--save-every`
steps and restarts from the newest checkpoint after a failed step
(`runtime.run_resilient`). Prints the reference's `step N {...}` lines, each
kernel's launch count, `done: N steps, R restarts, Xs` with `--ckpt-dir`, and
the reference's final JSON summary.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --method async_sam --steps 6 --batch 8 --seq 1024            # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --reduced \\
      --device cpu --method async_sam --steps 12 --batch 4 --seq 32 \\
      --save-every 6 --ckpt-dir /tmp/ck

`--optimizer sgd` takes the reference launcher's sgd: momentum 0 (the
paper's momentum 0.9 is `optim.sgd(..., momentum=0.9)` through the API).
The reference's other executors (hetero, remote), elastic meshes, the guard
and the tracker are later slices (ROADMAP.md queue 1); their flags are not
defined here.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import MethodConfig
from repro_torch.data import PipelineConfig, TokenPipeline
from repro_torch.engine import (CheckpointCallback, Engine, FusedExecutor, LoggingCallback,
                                ThroughputMeter)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_update as fu
from repro_torch.kernels import sam_perturb as sp
from repro_torch.launch.serve import resolve_device
from repro_torch.models import build_model
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.runtime import ResilienceConfig


def kernel_launches() -> dict[str, int]:
    """Launches of every kernel of the training path since the last reset."""
    return {"flash_attention": fa.launches, **sp.launches, **fu.launches}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-trainable)")
    ap.add_argument("--method", default="async_sam")
    ap.add_argument("--executor", choices=("fused",), default="fused",
                    help="fused: one step function per iteration (Form A)")
    ap.add_argument("--fused-update", choices=("auto", "on", "off"), default="auto",
                    help="flat-buffer fused perturb + optimizer epilogue (auto: on, the "
                         "kernels on the card and their plain versions on the CPU)")
    ap.add_argument("--resident", choices=("auto", "on", "off"), default="auto",
                    help="bucket-resident training state: params/opt-state persist as "
                         "dtype buckets, the step runs buffer->buffer (auto: follows the "
                         "resolved fused path; checkpoints stay per-leaf either way)")
    ap.add_argument("--restart-window-s", type=float, default=0.0,
                    help="rolling window for the checkpoint-restart budget: tolerate "
                         "--max-restarts within this many seconds instead of over the "
                         "whole run (0 = lifetime)")
    ap.add_argument("--max-restarts", type=int, default=5,
                    help="checkpoint-restart budget (per --restart-window-s window when set)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--rho", type=float, default=0.05)
    ap.add_argument("--ascent-fraction", type=float, default=0.25)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    bundle = build_model(cfg)
    mcfg = MethodConfig(name=args.method, rho=args.rho,
                        ascent_fraction=args.ascent_fraction,
                        n_microbatches=args.n_micro)
    optimizer = make_optimizer(args.optimizer,
                               cosine_schedule(args.lr, args.steps,
                                               warmup_steps=args.steps // 20))
    pipe = TokenPipeline(cfg, PipelineConfig(
        global_batch=args.batch, seq_len=args.seq, seed=args.seed,
        ascent_fraction=(args.ascent_fraction
                         if args.method in ("async_sam",) else 0.0)), device=device)
    switch = {"auto": None, "on": True, "off": False}
    executor = FusedExecutor(bundle.loss_fn, mcfg, optimizer,
                             fused_update=switch[args.fused_update],
                             resident=switch[args.resident])

    model = bundle.init(args.seed, device)
    state = executor.init_state(model, args.seed + 1)

    meter = ThroughputMeter(tokens_per_batch=args.batch * args.seq)
    callbacks = [LoggingCallback(every=args.log_every, total_steps=args.steps), meter]
    if args.ckpt_dir:
        callbacks.append(CheckpointCallback(
            CheckpointManager(args.ckpt_dir, keep=3),
            ResilienceConfig(save_every=args.save_every, max_restarts=args.max_restarts,
                             restart_window_s=args.restart_window_s or None)))
    with Engine(executor, pipe, callbacks) as eng:
        report = eng.fit(state, args.steps)

    if args.ckpt_dir:
        print(f"done: {report.steps_done} steps, {report.restarts} restarts, "
              f"{report.wall_time_s:.1f}s")
    print(f"kernel launches: {json.dumps(kernel_launches())}")
    summary = meter.summary()
    if summary:
        print(json.dumps({"arch": cfg.name, "method": args.method,
                          "executor": args.executor,
                          "steps": report.steps_done,
                          "mean_step_s": summary["mean_step_s"],
                          "tokens_per_s": summary.get("tokens_per_s")}))


if __name__ == "__main__":
    main()
