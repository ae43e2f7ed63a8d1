"""The model FLOPs of the work a cell's window asks for, from its
configuration and shapes: what the model's equations need, not what an
implementation runs (activation recompute is not counted).

A forward pass counts 2 operations a multiply-add of every matrix product,
as the configuration's family counts them (`forward_parts` of
`reference/families/<family>.py`): the projections, attention's scores and
weighted values over the (query, key) pairs a causal mask lets through, the
output head. Elementwise work and norms are not counted. A training pass
is the forward and a backward of twice its operations, over the rows the
traffic's method passes a step (`pass_rows` of
`reference/methods/<name>.py`: AsyncSAM's descent and ascent rows).
"""
from __future__ import annotations

from bench.reference import models
from bench.reference import train as ref_train


def forward_parts(cfg: dict, rows: int, seq: int, *, causal: bool = True,
                  head_positions: int = 0) -> dict[str, float]:
    """The family's FLOPs of a forward pass over `rows` x `seq` tokens, by
    part; the head over `head_positions` positions a row (0: all of
    them)."""
    return models.family(cfg).forward_parts(cfg, rows, seq, causal=causal,
                                            head_positions=head_positions)


def forward_flops(cfg: dict, rows: int, seq: int, **kw) -> float:
    return sum(forward_parts(cfg, rows, seq, **kw).values())


def train_step_flops(cfg: dict, traffic: dict) -> float:
    """One training step of a train traffic mix: 3 forward passes' worth
    over the rows its method passes."""
    rows = ref_train.method(traffic["method"]).pass_rows(traffic)
    return 3.0 * forward_flops(cfg, rows, traffic["seq"])


def prefill_flops(cfg: dict, rows: int, seq: int) -> float:
    """A prefill of rows x seq prompt tokens, the head at the last
    position only (the first token's logits)."""
    return forward_flops(cfg, rows, seq, head_positions=1)
