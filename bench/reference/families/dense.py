"""The ``dense`` family: a decoder of pre-norm blocks, each multi-head
causal attention with rotary positions (half-split rotation, base
``rope_theta``) and a gated MLP; OLMo's non-parametric LayerNorm (``norm``
"nonparam_ln") or RMSNorm with a scale; the output head tied to the
embedding where ``tie_embeddings`` is set (OLMo-1B, arXiv:2402.00838).

A family module gives `leaf_table`, `logits` and `forward_parts`.
"""
from __future__ import annotations

import math

import torch

from bench import roofline
from bench.reference import layers


def leaf_table(cfg: dict) -> dict[str, tuple[tuple[int, ...], tuple]]:
    """{leaf name: (shape, (rule, argument))} (rules: `weights.make_weights`);
    the names are the module paths under which the program under test keeps
    the same weights."""
    d, L = cfg["d_model"], cfg["n_layers"]
    out_scale = 1.0 / math.sqrt(2 * L)
    leaves = {"embedding.embed": ((cfg["vocab_size"], d), ("normal", 0.02))}
    if not cfg["tie_embeddings"]:
        leaves["embedding.unembed"] = ((d, cfg["vocab_size"]), ("dense", 1.0))
    leaves.update(layers.norm_leaves(cfg, "final_norm"))
    for i in range(L):
        p = f"blocks.{i}"
        leaves.update(layers.norm_leaves(cfg, f"{p}.ln1"))
        leaves.update(layers.norm_leaves(cfg, f"{p}.ln2"))
        leaves.update(layers.attn_leaves(cfg, f"{p}.attn", out_scale))
        leaves.update(layers.mlp_leaves(cfg, f"{p}.mlp"))
    return leaves


def logits(P: layers.Params, tokens: torch.Tensor, cfg: dict, mm: layers.MatMul,
           last_only: bool = False) -> torch.Tensor:
    """(B, S, V) logits of token rows (B, S), or (B, V) at the last position
    with `last_only`."""
    x = P["embedding.embed"][tokens.long()]
    for i in range(cfg["n_layers"]):
        p = f"blocks.{i}"
        x = x + layers.attention(P, f"{p}.attn", layers.norm(P, f"{p}.ln1", x, cfg), cfg, mm)
        x = x + layers.mlp(P, f"{p}.mlp", layers.norm(P, f"{p}.ln2", x, cfg), cfg, mm)
    if last_only:
        x = x[:, -1]
    x = layers.norm(P, "final_norm", x, cfg)
    head = P["embedding.embed"].T if cfg["tie_embeddings"] else P["embedding.unembed"]
    return mm(x, head)


def forward_parts(cfg: dict, rows: int, seq: int, *, causal: bool = True,
                  head_positions: int = 0) -> dict[str, float]:
    """{"projections", "attention", "head"} FLOPs of a forward pass over
    `rows` x `seq` tokens, 2 a multiply-add of every matrix product; the
    head over `head_positions` positions a row (0: all of them). `causal`
    False counts every (query, key) pair, as a product of the whole score
    matrix does."""
    d, h = cfg["d_model"], cfg["n_heads"]
    hd = layers.head_dim(cfg)
    proj = 2 * d * (h * hd + 2 * cfg["n_kv_heads"] * hd) + 2 * h * hd * d
    mlp = 2 * d * cfg["d_ff"] * (3 if cfg.get("mlp_gated", True) else 2)
    pairs = roofline.visible_pairs(seq, seq, causal)
    return {"projections": float(cfg["n_layers"] * rows * seq * (proj + mlp)),
            "attention": float(cfg["n_layers"] * 2 * 2 * hd * h * rows * pairs),
            "head": 2.0 * d * cfg["vocab_size"] * rows * (head_positions or seq)}
