"""Plain float32 models of the benchmark's configurations, one module a
family under `families/`, found by the configuration's ``family``: a new
family is a new file there with `leaf_table`, `logits` and `forward_parts`.

A model is a mapping of leaf names to tensors (`leaf_table` lists them) and
a config dict, the benchmark's configuration file. Every matrix product
goes through ``mm``, which is plain fp32 matmul by default; the control of
the correctness check hands in a lower-precision one (`precision.py`).
"""
from __future__ import annotations

import importlib

import torch

from bench.reference.layers import MatMul, Params


def fp32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def family(cfg: dict):
    """The module of the configuration's family (`families/<family>.py`)."""
    return importlib.import_module(f"bench.reference.families.{cfg['family']}")


def leaf_table(cfg: dict) -> dict[str, tuple[tuple[int, ...], tuple]]:
    return family(cfg).leaf_table(cfg)


def logits(P: Params, tokens: torch.Tensor, cfg: dict, mm: MatMul = fp32_mm,
           last_only: bool = False) -> torch.Tensor:
    return family(cfg).logits(P, tokens, cfg, mm, last_only)


def token_loss_sum(P: Params, tokens: torch.Tensor, labels: torch.Tensor, cfg: dict,
                   mm: MatMul = fp32_mm) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of next-token cross entropy over positions with a label >= 0,
    their count)."""
    lg = logits(P, tokens, cfg, mm)
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, labels.long().clamp_min(0)[..., None])[..., 0]
    mask = labels >= 0
    return ((lse - picked) * mask).sum(), mask.sum()


def loss_and_grads(P: Params, batch: dict, cfg: dict, mm: MatMul = fp32_mm,
                   rows: int = 1, keep: float = 1.0) -> tuple[float, dict[str, torch.Tensor]]:
    """Mean next-token cross entropy of a batch {"tokens", "labels"} and its
    gradient, `rows` rows at a time (the sum over the blocks of each block's
    sum over the batch's count). `keep` < 1 keeps that share of the batch's
    first rows, as a fault that leaves the others out."""
    n = max(1, round(batch["tokens"].shape[0] * keep))
    tokens, labels = batch["tokens"][:n], batch["labels"][:n]
    count = (labels >= 0).sum().clamp_min(1).to(torch.float32)
    leaves = {}
    for name, t in P.items():
        leaves[name] = t.detach().requires_grad_(True)
        leaves[name].grad = torch.zeros_like(t)
    total = 0.0
    for lo in range(0, tokens.shape[0], rows):
        s, _ = token_loss_sum(leaves, tokens[lo:lo + rows], labels[lo:lo + rows], cfg, mm)
        part = s / count
        part.backward()
        total += float(part.detach())
    return total, {name: t.grad for name, t in leaves.items()}


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(t.double().square().sum() for t in tree.values()))


def leaf_norms(tree: dict) -> dict[str, float]:
    norms = torch.stack([torch.linalg.vector_norm(t.double()) for t in tree.values()])
    return dict(zip(tree, norms.tolist()))
