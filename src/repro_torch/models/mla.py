"""Multi-head Latent Attention (DeepSeek-V2) with compressed-KV decode
(counterpart of `repro.models.mla`).

Training and prefill decompress the latent into full per-head K/V and run
the flash kernel (qk head dim nope + rope, v head dim `v_head_dim`: 192 / 128
at deepseek-v2-lite's width). Decode takes the absorbed form: the queries are
projected into the latent space, so the cache stays (S, kv_lora + rope_dim)
per token, and attention runs against the compressed cache in plain torch, as
the reference's does (it has no kernel there).
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, cdtype

Params = Mapping[str, torch.Tensor]


def mla_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {"wq": (d, h * qk_dim),
            "w_dkv": (d, m.kv_lora_rank + m.qk_rope_head_dim),
            "kv_norm_scale": (m.kv_lora_rank,),
            "w_uk": (m.kv_lora_rank, h * m.qk_nope_head_dim),
            "w_uv": (m.kv_lora_rank, h * m.v_head_dim),
            "wo": (h * m.v_head_dim, d)}


def _latent(params: Params, x: torch.Tensor, cfg: ModelConfig):
    """(the RMS-normalised compressed kv latent, the rope key before RoPE)."""
    m = cfg.mla
    dt = cdtype(cfg)
    ckv = x @ params["w_dkv"].to(dt)
    c_kv, k_rope = ckv[..., :m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    cf = c_kv.float()
    cf = cf * torch.rsqrt(cf.square().mean(dim=-1, keepdim=True) + 1e-6)
    c_kv = (cf * params["kv_norm_scale"].float()).to(dt)
    return c_kv, k_rope


def _queries(params: Params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    m = cfg.mla
    dt = cdtype(cfg)
    q = x @ params["wq"].to(dt)
    q = q.reshape(*q.shape[:-1], cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def mla_apply(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, cache: Optional[dict] = None
              ) -> tuple[torch.Tensor, dict]:
    """x: (B, S, D). Without a cache (train, prefill): flash attention over
    the decompressed K/V; returns (out, {"c_kv", "k_rope"}) of this segment.
    With a cache {"c_kv": (B, S_max, R), "k_rope": (B, S_max, rope), "pos"}
    (decode): the new latent is written at `pos` IN PLACE and the absorbed
    queries attend over the valid entries; returns (out, the cache)."""
    from repro_torch.kernels import ops  # local import to avoid cycles

    m = cfg.mla
    dt = cdtype(cfg)
    H = cfg.n_heads
    q_nope, q_rope = _queries(params, x, positions, cfg)
    c_kv, k_rope_raw = _latent(params, x, cfg)
    k_rope = apply_rope(k_rope_raw[..., None, :], positions, cfg.rope_theta)

    if cache is None:
        k_nope = (c_kv @ params["w_uk"].to(dt)).reshape(*x.shape[:-1], H, m.qk_nope_head_dim)
        v = (c_kv @ params["w_uv"].to(dt)).reshape(*x.shape[:-1], H, m.v_head_dim)
        # contiguous (B, S, H, nope + rope): the kernel's TMA path reads it
        k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:-1], m.qk_rope_head_dim)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = ops.flash_attention(q, k, v, causal=True)
        new_cache = {"c_kv": c_kv, "k_rope": k_rope[:, :, 0, :]}
    else:
        pos, s_new = cache["pos"], x.shape[1]
        ckv_c, krope_c = cache["c_kv"], cache["k_rope"]
        ckv_c[:, pos:pos + s_new] = c_kv.to(ckv_c.dtype)
        krope_c[:, pos:pos + s_new] = k_rope[..., 0, :].to(krope_c.dtype)
        # absorb w_uk into the query: q_lat (B, T, H, R)
        wuk = params["w_uk"].to(dt).reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
        q_lat = torch.einsum("bthn,rhn->bthr", q_nope, wuk)
        scores = (torch.einsum("bthr,bsr->bhts", q_lat.float(), ckv_c.float())
                  + torch.einsum("bthn,bsn->bhts", q_rope.float(), krope_c.float()))
        scores = scores / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
        valid = torch.arange(ckv_c.shape[1], device=x.device) < pos + s_new
        scores = torch.where(valid, scores, -1e30)
        probs = torch.softmax(scores, dim=-1)
        o_lat = torch.einsum("bhts,bsr->bthr", probs, ckv_c.float())
        wuv = params["w_uv"].to(dt).reshape(m.kv_lora_rank, H, m.v_head_dim)
        out = torch.einsum("bthr,rhv->bthv", o_lat.to(dt), wuv)
        new_cache = {"c_kv": ckv_c, "k_rope": krope_c, "pos": pos + s_new}

    out = out.reshape(*x.shape[:-1], H * m.v_head_dim)
    return out @ params["wo"].to(dt), new_cache
