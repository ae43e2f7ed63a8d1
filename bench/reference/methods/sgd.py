"""The base step ("sgd" in the program's method names): the gradient of the
descent rows at the weights, no ascent and no perturbation.

A method module gives `Method` (built from the traffic's method entry;
`step(w, batch, grads)` returns the descent loss and the gradient the
optimizer gets, `readings()` what else the check compares) and `pass_rows`
(the rows of the forward and backward passes a step makes, for the FLOPs).
"""
from __future__ import annotations


class Method:
    def __init__(self, method: dict):
        self.method = method

    def step(self, w: dict, batch: dict, grads) -> tuple[float, dict]:
        return grads(w, batch)

    def readings(self) -> dict:
        return {}


def pass_rows(traffic: dict) -> int:
    return traffic["rows"]
