"""AsyncSAM: sharpness-aware minimization whose ascent gradient is one step
stale, so the ascent pass leaves the critical path:

    a_t   = grad L_{b'}(w_t)                       on the ascent rows
    w_hat = w_t + rho a_{t-1} / ||a_{t-1}||         (w_t at the first step)
    g_t   = grad L_b(w_hat)                         on the descent rows

g_t goes to the optimizer. The check also compares the first ascent
gradient (its leaf norms and its global norm), which the program keeps in
its state as a_{t-1} for the next step, and the second step's perturbation
w_hat - w_t (its leaf norms).
"""
from __future__ import annotations

from bench.reference import models


class Method:
    def __init__(self, method: dict):
        self.rho = method["rho"]
        self.a_prev, self.a_norm = None, None
        self.first = {}

    def step(self, w: dict, batch: dict, grads) -> tuple[float, dict]:
        _, a_new = grads(w, batch["ascent"])
        if self.a_prev is None:
            w_hat = w
        else:
            scale = self.rho / (float(self.a_norm) + 1e-12)
            w_hat = {n: w[n] + scale * self.a_prev[n] for n in w}
            if "perturbation" not in self.first:
                self.first["perturbation"] = {n: scale * v for n, v in
                                              models.leaf_norms(self.a_prev).items()}
        loss, g = grads(w_hat, batch)
        del w_hat
        self.a_prev, self.a_norm = a_new, models.global_norm(a_new)
        if not self.first:
            self.first = {"ascent": models.leaf_norms(a_new), "ascent_norm": float(self.a_norm)}
        return loss, g

    def readings(self) -> dict:
        return dict(self.first)


def pass_rows(traffic: dict) -> int:
    return traffic["rows"] + traffic["method"]["ascent_rows"]
