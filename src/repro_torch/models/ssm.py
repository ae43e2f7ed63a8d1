"""Mamba2 (SSD) block of the zamba2 hybrid family (counterpart of
`repro.models.ssm`).

Sequence mixing goes through `repro_torch.kernels.ops.mamba2_mix` (the
Hopper kernel on the card); a decode step is one token through
`ops.mamba2_decode_step` (the same kernel, from the carried state). The
input projection is split per segment (z / x / BC / dt) as the reference's
is; the depthwise causal conv uses explicit shifts so that decode carries a
(width - 1)-deep conv cache. Parameters are mappings of the reference's leaf
names to tensors, as in `layers.py`.

Under a sequence block (`partitioning.seq_block`: the "fsdp_sp" profile,
x this rank's block of the sequence) the conv's first rows read the
previous block's last d_conv - 1 inputs (`distributed.halo_from_prev`), and
the SSD scan runs twice through the kernel: from a zero state, for the
block's final state S_r and log decay L_r = a_h sum_t dt; then, after the
model group has exchanged them (`distributed.gather_stack`) and each rank
has folded the exclusive prefix h_r (`distributed.state_prefix`), from h_r,
for y and the final state. The gradient reaches the other blocks through
the kernel's d_init_state and d_state. Every rank runs both passes (rank
0's from a zero h_0), so the ranks' graphs, and the collectives their
backward runs, are the same; rank 0's extra pass is off the group's
critical path (its causal attention is the group's least).

Under the "tp" layout ("model" dividing the heads) the mixer is handed the
rank's column shards of `wz`, `wx`, `wdt` and the x conv and the row shard
of `w_out` (`partitioning.tp_leaves`), and runs on its heads: f
(`distributed.copy_to_model`) on the normed input, the SSD scan on H/m
heads with B and C whole (`wbc` and the BC conv used whole on every rank:
zamba2's single group feeds every head), the gated RMSNorm's sum of
squares summed over the model group (`distributed.all_reduce_sum`),
`w_out`'s partial products summed (g). Every leaf it does not split is
partial: each rank's gradient is its heads' part. `mamba2_gated` and
`mamba2_out` are the collective-free pieces of rank r of m, which
`partitioning.mamba_share` cuts from whole weights.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.models import partitioning
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, cdtype
from repro_torch.utils import distributed


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    bc_dim = 2 * s.n_groups * s.d_state
    return s, d_inner, n_heads, bc_dim


def mamba2_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The leaves of the reference's `mamba2_init`, by name and shape."""
    s, d_inner, n_heads, bc_dim = _dims(cfg)
    d = cfg.d_model
    return {"wz": (d, d_inner), "wx": (d, d_inner), "wbc": (d, bc_dim), "wdt": (d, n_heads),
            "conv_x_w": (s.d_conv, d_inner), "conv_x_b": (d_inner,),
            "conv_bc_w": (s.d_conv, bc_dim), "conv_bc_b": (bc_dim,),
            "a_log": (n_heads,), "d_skip": (n_heads,), "dt_bias": (n_heads,),
            "gate_norm_scale": (d_inner,), "w_out": (d_inner, d)}


def _causal_conv(xin: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv via explicit shifts. xin (B,S,C); w (W,C).

    conv_state (B,W-1,C) holds the previous W-1 inputs (decode). Returns
    (silu(conv(x)+b), new_conv_state)."""
    W = w.shape[0]
    B, S, C = xin.shape
    if conv_state is None:
        conv_state = torch.zeros((B, W - 1, C), dtype=xin.dtype, device=xin.device)
    padded = torch.cat([conv_state.to(xin.dtype), xin], dim=1)     # (B, S+W-1, C)
    y = torch.zeros((B, S, C), dtype=torch.float32, device=xin.device)
    for i in range(W):
        y = y + padded[:, i:i + S].float() * w[i].float()
    y = F.silu(y + b.float()).to(xin.dtype)
    return y, padded[:, S:]                                         # last W-1 inputs


def mamba2_gated(params: Params, x: torch.Tensor, cfg: ModelConfig, r: int = 0, m: int = 1, *,
                 cache: Optional[dict] = None) -> tuple[torch.Tensor, dict]:
    """The mixer of heads [r H/m, (r+1) H/m) up to its gated norm, without
    collectives but the sequence blocks' (`partitioning.mamba_share`'s
    weights: `wz` / `wx` / `wdt` / the x conv on the heads' columns, B and
    C whole; r 0 of m 1: every head): (y * silu(z) (B,S,d_inner/m) in
    fp32, the cache: the conv tails (the x conv's the heads' columns) and
    the heads' SSM state). cache: {"conv_x", "conv_bc", "ssm"} of the
    same heads."""
    from repro_torch.kernels import ops  # local import to avoid cycles

    s, d_inner, n_heads, bc_dim = _dims(cfg)
    dt_c = cdtype(cfg)
    h = n_heads // m
    lo, hi = r * h, (r + 1) * h
    B, S, _ = x.shape
    z = x @ params["wz"].to(dt_c)
    xs = x @ params["wx"].to(dt_c)
    bc = x @ params["wbc"].to(dt_c)
    dt_raw = x @ params["wdt"].to(dt_c)

    lay = partitioning.current_layout() if cache is None and partitioning.seq_block() else None
    if lay is not None:           # this rank's block: the conv's halo from the previous one
        halo_x = distributed.halo_from_prev(xs, s.d_conv - 1, lay)
        halo_bc = distributed.halo_from_prev(bc, s.d_conv - 1, lay)
    else:
        halo_x, halo_bc = (cache["conv_x"], cache["conv_bc"]) if cache else (None, None)
    xs, new_conv_x = _causal_conv(xs, params["conv_x_w"], params["conv_x_b"], halo_x)
    bc, new_conv_bc = _causal_conv(bc, params["conv_bc_w"], params["conv_bc_b"], halo_bc)
    gn = s.n_groups * s.d_state
    b = bc[..., :gn].reshape(B, S, s.n_groups, s.d_state).contiguous()
    c = bc[..., gn:].reshape(B, S, s.n_groups, s.d_state).contiguous()
    xh = xs.reshape(B, S, h, s.head_dim)
    dt = F.softplus(dt_raw.float() + params["dt_bias"][lo:hi].float())
    a = -torch.exp(params["a_log"][lo:hi].float())
    d_skip = params["d_skip"][lo:hi].float()

    if lay is not None:
        # the state chained over the blocks: this block's zero-start final
        # state and log decay, every block's gathered, this rank's prefix
        _, s_r = ops.mamba2_mix(xh, dt, a, b, c, d_skip, chunk=s.chunk_size)
        st = distributed.state_prefix(distributed.gather_stack(s_r, lay),
                                      distributed.gather_stack(a * dt.sum(dim=1), lay), lay.r)
        y, final_state = ops.mamba2_mix(xh, dt, a, b, c, d_skip, chunk=s.chunk_size,
                                        init_state=st)
    elif cache is None:
        y, final_state = ops.mamba2_mix(xh, dt, a, b, c, d_skip, chunk=s.chunk_size)
    else:
        y, final_state = ops.mamba2_decode_step(xh, dt, a, b, c, d_skip, state=cache["ssm"])
    # the final state and the conv tails are the prefill's cache
    new_cache = {"conv_x": new_conv_x, "conv_bc": new_conv_bc, "ssm": final_state}
    return y.reshape(B, S, h * s.head_dim).float() * F.silu(z.float()), new_cache


def mamba2_out(params: Params, yf: torch.Tensor, sq_sum: torch.Tensor, cfg: ModelConfig,
               r: int = 0, m: int = 1) -> torch.Tensor:
    """The gated RMSNorm and the out projection of the heads' columns yf
    (`mamba2_gated`), `sq_sum` (B,S,1) the sum of squares over the whole
    d_inner (the m shares' sums added): the heads' part of the output,
    which the m parts sum to."""
    _, d_inner, _, _ = _dims(cfg)
    dt_c = cdtype(cfg)
    w = yf.shape[-1]
    yf = yf * torch.rsqrt(sq_sum / d_inner + 1e-6)
    y = (yf * params["gate_norm_scale"][r * w:(r + 1) * w].float()).to(dt_c)
    return y @ params["w_out"].to(dt_c)


def mamba2_apply(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 cache: Optional[dict] = None) -> tuple[torch.Tensor, dict]:
    """x (B,S,D) -> (y, cache'). cache: {"conv_x", "conv_bc", "ssm"}. With
    `wz` this rank's column shard (the "tp" layout): the rank's heads
    (`mamba2_gated`, f on x), the gated norm's sum of squares summed over
    the model group, `w_out`'s row shard's product summed over it (g); the
    cache's x conv tail and SSM state the rank's."""
    split = params["wz"].shape[-1] != cfg.ssm.expand * cfg.d_model
    lay = partitioning.tp_layout(cfg) if split else None
    if split and lay is None:
        raise ValueError("mamba2's mixer weights are a rank's share, but no "
                         "tensor-parallel layout is installed")
    r, m = (lay.r, lay.m) if lay is not None else (0, 1)
    if lay is not None:
        x = distributed.copy_to_model(x, lay.model_group)
    yf, new_cache = mamba2_gated(params, x, cfg, r, m, cache=cache)
    sq = yf.square().sum(dim=-1, keepdim=True)
    if lay is not None:
        sq = distributed.all_reduce_sum(sq, lay.model_group)
    out = mamba2_out(params, yf, sq, cfg, r, m)
    if lay is not None:
        out = distributed.reduce_from_model(out, lay.model_group)
    return out, new_cache


def mamba2_cache_shape(cfg: ModelConfig, batch: int,
                       device: Union[str, torch.device] = "cuda") -> dict:
    """One layer's zero decode cache: the conv tails in the compute dtype,
    the SSM state in fp32."""
    s, d_inner, n_heads, bc_dim = _dims(cfg)
    cdt = cdtype(cfg)
    return {"conv_x": torch.zeros((batch, s.d_conv - 1, d_inner), dtype=cdt, device=device),
            "conv_bc": torch.zeros((batch, s.d_conv - 1, bc_dim), dtype=cdt, device=device),
            "ssm": torch.zeros((batch, n_heads, s.head_dim, s.d_state), dtype=torch.float32,
                               device=device)}
