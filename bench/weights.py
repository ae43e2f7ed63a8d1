"""Weights and token rows made from the run's seed on the run's device.

Every random number comes from a `torch.Generator` on the device, seeded
from (seed, stream, index) through `numpy.random.SeedSequence`, so one seed
gives the same weights and rows in every run on one kind of device, and
any whole number is a seed. The weights are one draw of normals over all
leaves, shaped and scaled leaf by leaf as `reference.models.leaf_table`
says; the same draw serves the program under test and the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from bench.reference import models

WEIGHTS, DESCENT, ASCENT, PROMPTS, SAMPLE = range(5)


def generator(seed: int, stream: int, index: int, device) -> torch.Generator:
    words = np.random.SeedSequence([seed % 2**63, stream, index]).generate_state(2)
    return torch.Generator(device=device).manual_seed(int(words[0]) << 32 | int(words[1]))


def make_weights(cfg: dict, seed: int, device) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(the flat fp32 buffer, {leaf name: its view}) of the configuration's
    weights for `seed`. Rules of the family's `leaf_table`: "dense" draws
    N(0, 1) / sqrt(fan-in) times the argument (fan-in the next-to-last
    dim), "normal" N(0, 1) times the argument, "const" fills the argument."""
    table = models.leaf_table(cfg)
    total = sum(math.prod(shape) for shape, _ in table.values())
    flat = torch.randn(total, generator=generator(seed, WEIGHTS, 0, device), device=device)
    views, off = {}, 0
    with torch.no_grad():
        for name, (shape, (rule, arg)) in table.items():
            n = math.prod(shape)
            v = flat[off:off + n].view(shape)
            off += n
            if rule == "dense":
                v.mul_(arg / math.sqrt(shape[-2]))
            elif rule == "normal":
                v.mul_(arg)
            elif rule == "const":
                v.fill_(arg)
            else:
                raise ValueError(f"{name}: unknown rule {rule!r}")
            views[name] = v
    return flat, views


def load_into(model: torch.nn.Module, views: dict[str, torch.Tensor]) -> None:
    """Copy the weights into the program's model, whose parameters must be
    exactly the leaves the table names, with the same shapes."""
    params = dict(model.named_parameters())
    if set(params) != set(views):
        raise ValueError(f"the program's parameters and the benchmark's leaves differ: "
                         f"{sorted(set(params) ^ set(views))[:8]}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(views[name].shape):
                raise ValueError(f"{name}: program {tuple(p.shape)}, "
                                 f"benchmark {tuple(views[name].shape)}")
            p.copy_(views[name])


def token_rows(seed: int, stream: int, index: int, rows: int, seq: int, vocab: int,
               device) -> dict[str, torch.Tensor]:
    """{"tokens", "labels"} of `rows` x `seq` uniform tokens (int32), the
    labels the tokens shifted left with -1 (no label) at the last place."""
    tokens = torch.randint(0, vocab, (rows, seq), generator=generator(seed, stream, index, device),
                           device=device, dtype=torch.int32)
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -1
    return {"tokens": tokens, "labels": labels}
