"""Plain float32 layers that the reference's families share, written from
the published equations with nothing but `torch` operations. Every matrix
product goes through `mm` (`models.fp32_mm`, or the control's
lower-precision one)."""
from __future__ import annotations

import math
from typing import Callable, Mapping

import torch
import torch.nn.functional as F

Params = Mapping[str, torch.Tensor]
MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def norm_leaves(cfg: dict, prefix: str) -> dict:
    if cfg["norm"] == "nonparam_ln":
        return {}
    if cfg["norm"] == "rmsnorm":
        return {f"{prefix}.scale": ((cfg["d_model"],), ("const", 1.0))}
    raise ValueError(f"norm {cfg['norm']!r} is not modelled here")


def attn_leaves(cfg: dict, prefix: str, out_scale: float) -> dict:
    d, hd = cfg["d_model"], head_dim(cfg)
    return {f"{prefix}.wq": ((d, cfg["n_heads"] * hd), ("dense", 1.0)),
            f"{prefix}.wk": ((d, cfg["n_kv_heads"] * hd), ("dense", 1.0)),
            f"{prefix}.wv": ((d, cfg["n_kv_heads"] * hd), ("dense", 1.0)),
            f"{prefix}.wo": ((cfg["n_heads"] * hd, d), ("dense", out_scale))}


def mlp_leaves(cfg: dict, prefix: str) -> dict:
    d, f = cfg["d_model"], cfg["d_ff"]
    return {f"{prefix}.wi": ((d, f), ("dense", 1.0)),
            f"{prefix}.wg": ((d, f), ("dense", 1.0)),
            f"{prefix}.wo_mlp": ((f, d), ("dense", 1.0))}


def norm(P: Params, prefix: str, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm, or RMSNorm with a scale."""
    if cfg["norm"] == "nonparam_ln":
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-6)
    y = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-6)
    return y * P[f"{prefix}.scale"]


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd), positions 0..S-1; rotates the two halves of each
    head."""
    hd, s = x.shape[-1], x.shape[1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def attention(P: Params, prefix: str, x: torch.Tensor, cfg: dict, mm: MatMul) -> torch.Tensor:
    """Causal multi-head attention with rotary positions; x (B, S, d)."""
    b, s, _ = x.shape
    hd, h, kv = head_dim(cfg), cfg["n_heads"], cfg["n_kv_heads"]
    q = mm(x, P[f"{prefix}.wq"]).view(b, s, h, hd)
    k = mm(x, P[f"{prefix}.wk"]).view(b, s, kv, hd)
    v = mm(x, P[f"{prefix}.wv"]).view(b, s, kv, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    if kv != h:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))              # (B, H, S, hd)
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    out = mm(probs, v).transpose(1, 2).reshape(b, s, h * hd)
    return mm(out, P[f"{prefix}.wo"])


def mlp(P: Params, prefix: str, x: torch.Tensor, cfg: dict, mm: MatMul) -> torch.Tensor:
    h = act(mm(x, P[f"{prefix}.wi"]), cfg["act"]) * mm(x, P[f"{prefix}.wg"])
    return mm(h, P[f"{prefix}.wo_mlp"])
