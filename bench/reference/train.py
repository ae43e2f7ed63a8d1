"""The training cells' reference: the traffic's method
(`methods/<name>.py`) and optimizer (`optimizers/<name>.py`) run in plain
float32 over the first steps, and what the correctness check compares."""
from __future__ import annotations

import importlib

import torch

from bench.reference import models


def method(m: dict):
    """The module of the traffic's method entry (`methods/<name>.py`)."""
    return importlib.import_module(f"bench.reference.methods.{m['name']}")


def optimizer(o: dict):
    """The module of the traffic's optimizer entry (`optimizers/<name>.py`)."""
    return importlib.import_module(f"bench.reference.optimizers.{o['name']}")


def readings(P0: dict, batches: list[dict], cfg: dict, opt: dict, meth: dict,
             mm: models.MatMul = models.fp32_mm, rows: int = 1,
             keep: float = 1.0, update: bool = True) -> dict:
    """Run len(batches) steps from the weights P0 (left as they are) and
    return {"loss": each step's descent loss, "grad": the leaf norms of the
    first step's gradient as the optimizer gets it, "change": the leaf
    norms of w - w0 after the last step} and the
    method's own readings. Each batch is {"tokens", "labels"}, with
    "ascent" rows where the method has them. `rows` rows run at a time;
    `keep` < 1 keeps that share of each batch's rows, and `update` False
    skips every update (two faults)."""
    w = {n: p.detach().clone() for n, p in P0.items()}
    opt_rule = optimizer(opt).Optimizer(w, opt)
    step_rule = method(meth).Method(meth)

    def grads(params, batch):
        return models.loss_and_grads(params, batch, cfg, mm, rows, keep)

    out = {"loss": [], "grad": None}
    for batch in batches:
        loss, g = step_rule.step(w, batch, grads)
        if out["grad"] is None:
            out["grad"] = models.leaf_norms(g)
        if update:
            opt_rule.update(w, g)
        del g
        out["loss"].append(loss)
    with torch.no_grad():
        out["change"] = {n: float(torch.linalg.vector_norm((w[n] - P0[n]).double())) for n in w}
    return {**out, **step_rule.readings()}
