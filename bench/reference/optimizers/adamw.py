"""AdamW with decoupled weight decay under a cosine learning rate with no
warm-up, in plain float32.

An optimizer module gives `Optimizer(params, opt)`, the traffic's
optimizer entry, with `update(w, g)` in place.
"""
from __future__ import annotations

import math

import torch


def cosine_lr(opt: dict, step: int) -> float:
    """The learning rate of step `step` (0 for the first) under a cosine
    from `lr` over `total_steps`."""
    frac = min(1.0, step / max(1.0, opt["total_steps"]))
    return opt["lr"] * 0.5 * (1.0 + math.cos(math.pi * frac))


class Optimizer:
    def __init__(self, params: dict, opt: dict):
        self.opt = opt
        self.t = 0
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def update(self, w: dict, g: dict) -> None:
        o = self.opt
        lr = cosine_lr(o, self.t)
        self.t += 1
        c1, c2 = 1.0 - o["b1"] ** self.t, 1.0 - o["b2"] ** self.t
        for n in w:
            self.mu[n].mul_(o["b1"]).add_(g[n], alpha=1.0 - o["b1"])
            self.nu[n].mul_(o["b2"]).addcmul_(g[n], g[n], value=1.0 - o["b2"])
            upd = (self.mu[n] / c1) / (torch.sqrt(self.nu[n] / c2) + o["eps"])
            upd.add_(w[n], alpha=o["weight_decay"])
            w[n].sub_(upd, alpha=lr)
