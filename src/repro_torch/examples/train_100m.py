"""End-to-end script: train a ~100M-parameter qwen3-family model with AsyncSAM
for a few hundred steps, with checkpointing and restart, all through
`Engine.fit` with a CheckpointCallback.

The defaults (~100M parameters, 300 steps of 8 x 256 tokens) run on the card
in minutes and on a CPU in far longer. `--full` trains the qwen3-8b config
at its published widths instead, at the depth one 80 GB card holds for a
training step (FULL_LAYERS of its 36 layers).

    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 300 [--device cpu] [--full]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import MethodConfig
from repro_torch.data import PipelineConfig, TokenPipeline
from repro_torch.engine import CheckpointCallback, Engine, FusedExecutor, LoggingCallback
from repro_torch.launch.serve import resolve_device
from repro_torch.models import analytic_param_count, build_model
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import ResilienceConfig

CFG_100M = ModelConfig(
    name="qwen3-100m", family="dense",
    n_layers=8, d_model=640, n_heads=10, n_kv_heads=2, d_ff=2048,
    vocab_size=32000, head_dim=64, act="silu", qk_norm=True,
    remat="none", compute_dtype="float32",
)
# qwen3-8b's training step on one 80 GB card: its 151,936-entry embedding
# and fp32 logits leave room for 2 of its 36 layers (chip_smoke.py's train
# phase finds the same depth at 8 x 1024 tokens)
FULL_LAYERS = 2


def main(argv=None, *, cfg: ModelConfig = CFG_100M) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_100m"))
    ap.add_argument("--method", default="async_sam")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help=f"qwen3-8b at its published widths, {FULL_LAYERS} layers")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.full:
        cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=FULL_LAYERS)
    bundle = build_model(cfg)
    print(f"params: {analytic_param_count(cfg) / 1e6:.1f}M ({cfg.name}, {cfg.n_layers} layers)")

    mcfg = MethodConfig(name=args.method, rho=0.05, ascent_fraction=0.25)
    opt = optim.adamw(optim.cosine_schedule(3e-4, args.steps, warmup_steps=20), clip_norm=1.0)
    executor = FusedExecutor(bundle.loss_fn, mcfg, opt)
    state = executor.init_state(bundle.init(0, device), 1)

    pipe = TokenPipeline(cfg, PipelineConfig(global_batch=args.batch, seq_len=args.seq,
                                             ascent_fraction=0.25), device=device)
    callbacks = [
        LoggingCallback(every=20, total_steps=args.steps),
        CheckpointCallback(CheckpointManager(args.ckpt_dir, keep=2),
                           ResilienceConfig(save_every=100)),
    ]
    with Engine(executor, pipe, callbacks) as eng:
        report = eng.fit(state, args.steps)
    losses = [h["loss"] for h in report.metrics_history if "loss" in h]
    print(f"done: steps={report.steps_done} restarts={report.restarts} "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({report.wall_time_s:.0f}s)")
    return {"steps": report.steps_done, "restarts": report.restarts, "first_loss": losses[0],
            "final_loss": losses[-1], "wall_s": report.wall_time_s}


if __name__ == "__main__":
    main()
