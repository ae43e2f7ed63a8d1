"""`bench/flops.py` against PyTorch's own count (`FlopCounterMode`) of the
plain reference's forward pass at the reduced presets' sizes, with no
recompute; and a wrong count that the same comparison refuses."""
from __future__ import annotations

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import flops, harness, weights
from bench.reference import models
from repro_torch.configs import get_config

ARCHS = [c["name"] for c in harness.benchmark()["configs"]]


def counted(arch: str, rows: int, seq: int) -> tuple[float, dict]:
    cfg = dataclasses.asdict(get_config(arch, reduced=True))
    _, w = weights.make_weights(cfg, 3, "cpu")
    tok = weights.token_rows(3, weights.PROMPTS, 0, rows, seq, cfg["vocab_size"], "cpu")["tokens"]
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        models.logits(w, tok, cfg)
    return float(fc.get_total_flops()), cfg


def matches(ours: float, torch_count: float) -> bool:
    return abs(ours - torch_count) <= 1e-9 * torch_count


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_flops_match_the_counter(arch):
    got, cfg = counted(arch, 2, 24)
    # the counter sees the whole score matrix's product
    assert matches(flops.forward_flops(cfg, 2, 24, causal=False), got)


def test_a_wrong_count_fails_the_comparison():
    got, cfg = counted("olmo-1b", 2, 24)
    parts = flops.forward_parts(cfg, 2, 24, causal=False)
    assert not matches(parts["projections"] + parts["attention"], got)        # head left out
    assert not matches(sum(flops.forward_parts(cfg, 2, 24).values()), got)   # causal pairs


@pytest.mark.parametrize("method,rows", [
    ({"name": "async_sam", "rho": 0.05, "ascent_rows": 2}, 10), ({"name": "sgd"}, 8)])
def test_train_and_prefill_counts(method, rows):
    cfg = dataclasses.asdict(get_config("olmo-1b"))
    traffic = {"rows": 8, "seq": 2048, "method": method}
    fwd = flops.forward_flops(cfg, rows, 2048)
    assert flops.train_step_flops(cfg, traffic) == 3 * fwd
    # 2 x 1.18e9 parameters' products a token, and the causal attention
    assert 2.3e9 * 2048 * rows < fwd < 2.6e9 * 2048 * rows
    pre = flops.prefill_flops(cfg, 8, 2048)
    assert pre < flops.forward_flops(cfg, 8, 2048)
    assert pre == flops.forward_flops(cfg, 8, 2048) - 2 * 2048 * 50304 * 8 * 2047
