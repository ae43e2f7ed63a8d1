"""Quickstart: train a small LM with AsyncSAM through the Engine in ~30 lines.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.core import MethodConfig
from repro_torch.data import PipelineConfig, TokenPipeline
from repro_torch.engine import Engine, FusedExecutor, LoggingCallback
from repro_torch.launch.serve import resolve_device
from repro_torch.models import build_model


def main(argv=None, *, steps: int = 200) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. pick an architecture (any of the 10 assigned ids) at smoke scale
    cfg = get_config("olmo-1b", reduced=True)
    bundle = build_model(cfg)

    # 2. choose the training method: AsyncSAM is the paper's contribution;
    #    rho is the perturbation radius, ascent_fraction is b'/b (paper 3.3)
    mcfg = MethodConfig(name="async_sam", rho=0.05, ascent_fraction=0.25)
    optimizer = optim.adamw(optim.cosine_schedule(3e-3, steps))

    # 3. an executor owns init and the step; the Engine owns the loop and the
    #    callbacks. Swap FusedExecutor for HeteroExecutor to run the two-lane
    #    schedule; nothing else changes.
    executor = FusedExecutor(bundle.loss_fn, mcfg, optimizer)
    state = executor.init_state(bundle.init(0, device), 1)

    # 4. stream data (the pipeline emits the b'-sized ascent sub-batch too)
    pipe = TokenPipeline(cfg, PipelineConfig(global_batch=8, seq_len=64,
                                             ascent_fraction=0.25), device=device)
    t0 = time.perf_counter()
    with Engine(executor, pipe, [LoggingCallback(every=25)]) as eng:
        report = eng.fit(state, steps=steps)
    wall_s = time.perf_counter() - t0
    final = float(report.metrics_history[-1]["loss"])
    print("final loss:", final)
    return {"final_loss": final, "first_loss": float(report.metrics_history[0]["loss"]),
            "steps": report.steps_done, "wall_s": wall_s}


if __name__ == "__main__":
    main()
