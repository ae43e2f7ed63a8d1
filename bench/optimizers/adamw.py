"""AdamW as the program under test builds it (`repro_torch.optim.adamw`
under `cosine_schedule`, no warm-up), and the check's reading of its state.

An optimizer module here gives `build(o)`, the program's optimizer for the
traffic's optimizer entry, and `first_grad_norms(opt_state, o)`, the leaf
norms of the gradient that the first update got, read from its state.
"""
from __future__ import annotations

import math

import torch


def build(o: dict):
    from repro_torch.optim import adamw, cosine_schedule
    return adamw(cosine_schedule(o["lr"], o["total_steps"], warmup_steps=0), b1=o["b1"],
                 b2=o["b2"], eps=o["eps"], weight_decay=o["weight_decay"])


def first_grad_norms(opt_state, o: dict) -> dict[str, float]:
    """||g_1|| a leaf from the second moment after one step,
    nu_1 = (1 - b2) g_1^2, summed over the leaf."""
    adam = next(s for s in opt_state if hasattr(s, "nu"))
    tree = adam.nu.to_tree() if hasattr(adam.nu, "to_tree") else dict(adam.nu)
    sums = torch.stack([v.double().sum() for v in tree.values()]).tolist()
    return {k: math.sqrt(v / (1.0 - o["b2"])) for k, v in zip(tree, sums)}
