"""Multi-head Latent Attention (DeepSeek-V2) with compressed-KV decode
(counterpart of `repro.models.mla`).

Training and prefill decompress the latent into full per-head K/V and run
the flash kernel (qk head dim nope + rope, v head dim `v_head_dim`: 192 / 128
at deepseek-v2-lite's width). Decode takes the absorbed form: the queries are
projected into the latent space, so the cache stays (S, kv_lora + rope_dim)
per token, and attention runs against the compressed cache in plain torch, as
the reference's does (it has no kernel there). Under the tensor-parallel
layout MLA computes on the rank's heads, and decode over a latent cache
split on its sequence combines the ranks' parts (`mla_apply`); under the
sequence-parallel one each rank's queries attend over k and v gathered
from every block.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch

from repro_torch.models import partitioning
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, cdtype, write_positions
from repro_torch.utils import distributed

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
    """(q_nope, q_rope) on the heads of `wq`'s columns: all, or this rank's."""
    m = cfg.mla
    dt = cdtype(cfg)
    q = x @ params["wq"].to(dt)
    q = q.reshape(*q.shape[:-1], -1, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def absorbed_decode_part(q_lat: torch.Tensor, q_rope: torch.Tensor, c_kv: torch.Tensor,
                         k_rope: torch.Tensor, valid_len: int, kv_offset: int, cfg: ModelConfig
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The absorbed decode over a latent cache, or one rank's block of it
    (c_kv (B, n, R), k_rope (B, n, rope) at positions kv_offset ..
    kv_offset + n - 1), entries at or past `valid_len` masked: (row max m
    (B,H,T), l = sum exp(s - m), o = sum exp(s - m) c_kv (B,H,T,R)) in
    fp32, `layers.decode_attention_part`'s contract; o / l is the whole
    cache's attention, and `distributed.lse_combine` combines the blocks'.
    q_lat (B,T,H,R), q_rope (B,T,H,rope)."""
    m = cfg.mla
    scores = (torch.einsum("bthr,bsr->bhts", q_lat.float(), c_kv.float())
              + torch.einsum("bthn,bsn->bhts", q_rope.float(), k_rope.float()))
    scores = scores / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    mask = kv_offset + torch.arange(c_kv.shape[1], device=q_lat.device) < valid_len
    scores = torch.where(mask, scores, -1e30)
    mx = scores.amax(dim=-1)
    p = torch.where(mask, torch.exp(scores - mx[..., None]), 0.0)
    return mx, p.sum(dim=-1), torch.einsum("bhts,bsr->bhtr", p, c_kv.float())


def mla_apply(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, cache: Optional[dict] = None
              ) -> tuple[torch.Tensor, dict]:
    """x: (B, S, D). Without a cache (train, prefill): flash attention over
    the decompressed K/V; returns (out, {"c_kv", "k_rope"}) of this segment.
    With a cache {"c_kv": (B, S_max, R), "k_rope": (B, S_max, rope), "pos"}
    (decode): the new latent is written at `pos` IN PLACE and the absorbed
    queries attend over the valid entries; returns (out, the cache).

    With `wq` this rank's column shard (the tensor-parallel layout, where
    the heads divide "model") the heads are this rank's H/m: the latent is
    computed whole on every rank (`w_dkv` and `kv_norm_scale` used whole,
    their gradients partial), q and the up-projections `w_uk` / `w_uv` on
    the rank's columns, flash on the local heads, `wo`'s row shard summed
    over the model group. Decode over a cache split on its sequence
    (`partitioning.cache_block`) gathers the queries of every head, attends
    over the rank's block (`absorbed_decode_part`), combines the parts over
    the group and keeps the rank's heads for `w_uv` and `wo`.

    Under a sequence block (`partitioning.seq_block`: x this rank's block,
    `positions` absolute, whole weights) k and v are decompressed from the
    block's latents and gathered whole over the model group
    (`distributed.gather_seq`), and the flash kernel runs with the block's
    query offset; the returned latents are the block's (the prefill
    gathers them for its cache)."""
    from repro_torch.kernels import ops  # local import to avoid cycles

    m = cfg.mla
    dt = cdtype(cfg)
    lay = None
    if params["wq"].shape[-1] != cfg.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim):
        lay = partitioning.tp_layout(cfg)
        x = distributed.copy_to_model(x, lay.model_group)
    q_nope, q_rope = _queries(params, x, positions, cfg)
    H = q_nope.shape[-2]
    c_kv, k_rope_raw = _latent(params, x, cfg)
    k_rope = apply_rope(k_rope_raw[..., None, :], positions, cfg.rope_theta)

    if cache is None:
        k_nope = (c_kv @ params["w_uk"].to(dt)).reshape(*x.shape[:-1], H, m.qk_nope_head_dim)
        v = (c_kv @ params["w_uv"].to(dt)).reshape(*x.shape[:-1], H, m.v_head_dim)
        # contiguous (B, S, H, nope + rope): the kernel's TMA path reads it
        k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:-1], m.qk_rope_head_dim)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        blk = partitioning.seq_block()
        if blk is not None:   # this rank's block: k and v of every block
            here = partitioning.current_layout()
            k, v = distributed.gather_seq(k, here), distributed.gather_seq(v, here)
        out = ops.flash_attention(q, k, v, causal=True, q_offset=0 if blk is None else blk[0])
        new_cache = {"c_kv": c_kv, "k_rope": k_rope[:, :, 0, :]}
    else:
        pos, s_new = cache["pos"], x.shape[1]
        ckv_c, krope_c = cache["c_kv"], cache["k_rope"]
        blk = partitioning.cache_block(ckv_c.shape[1])
        lo = 0 if blk is None else blk[0]
        write_positions(ckv_c, c_kv, pos, lo)
        write_positions(krope_c, k_rope[..., 0, :], pos, lo)
        # absorb w_uk into the query: q_lat (B, T, H, R)
        wuk = params["w_uk"].to(dt).reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
        q_lat = torch.einsum("bthn,rhn->bthr", q_nope, wuk)
        if blk is not None and lay is not None:   # every head's queries
            q_lat, q_rope = (distributed.all_heads(t, lay) for t in (q_lat, q_rope))
        mx, l, o = absorbed_decode_part(q_lat, q_rope, ckv_c, krope_c, pos + s_new, lo, cfg)
        if blk is None:
            o_lat = (o / l[..., None]).transpose(1, 2)
        else:
            o_lat = distributed.lse_combine(mx, l, o, blk[2]).transpose(1, 2)
            if lay is not None:   # the rank's heads
                o_lat = o_lat.narrow(2, lay.r * H, H)
        wuv = params["w_uv"].to(dt).reshape(m.kv_lora_rank, H, m.v_head_dim)
        out = torch.einsum("bthr,rhv->bthv", o_lat.to(dt), wuv)
        new_cache = {"c_kv": ckv_c, "k_rope": krope_c, "pos": pos + s_new}

    out = out.reshape(*x.shape[:-1], H * m.v_head_dim) @ params["wo"].to(dt)
    return (out if lay is None else distributed.reduce_from_model(out, lay.model_group),
            new_cache)
