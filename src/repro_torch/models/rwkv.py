"""RWKV6 ("Finch") blocks: time-mix with data-dependent decay + channel-mix
(counterpart of `repro.models.rwkv`).

The wkv recurrence goes through `repro_torch.kernels.ops.rwkv6_mix` (the
Hopper kernel on the card). Token-shift lerps use static per-channel mix
coefficients; the decay w is data-dependent through a low-rank MLP and is
computed in fp32. Decode carries the shift states (compute dtype) and the
per-head wkv state (fp32). Parameters are mappings of the reference's leaf
names to tensors, as in `layers.py`.

Under the "tp" layout (`partitioning.tp_layout`) a mix is handed the
rank's shards of its split weights (`partitioning.tp_leaves`) and reads
its layout from their shapes, as `layers.attention_apply` does:
  * the time mix (`wr`'s columns) runs on the rank's heads: r, k, v, g and
    the log decay on its columns, the wkv scan, the per-head norm and the
    gate on its heads, and `wo`'s row shard's product summed over the model
    group (Megatron's g); its state is the rank's heads' (B, H/m, K, V);
  * the channel mix (`wk_c`'s columns) runs on the rank's d_ff: each
    rank's partial v = relu(xk Wk)^2 Wv over its d_ff is reduce-scattered
    over d_model, the receptance gate computed on the rank's columns of
    `wr_c` multiplies the summed v there (the gate multiplies the sum, so
    it cannot go inside it), and the gated columns are all-gathered. Every
    product is split: a token costs d_model (2 d_ff + d_model) / m
    multiply-adds a rank, no d_model^2 repeated on every rank.
f (`distributed.copy_to_model`) sits on each mix's input, so each rank's
gradient of a leaf that it uses whole or a slice of (the mixes, the
decay's LoRA, w0, the bonus, the norm scale) is its own part: those leaves
are partial, their gradients summed over the model group. `timemix_part`
and the channel mix's `channel_value` / `channel_gate` are the collective-
free pieces of rank r of m, which `partitioning.rwkv_share` cuts from
whole weights.

Under a sequence block (`partitioning.seq_block`: the "fsdp_sp" profile,
x this rank's block of the sequence, whole weights) both mixes' token
shift takes the previous block's last row (`distributed.halo_from_prev`),
and the wkv scan runs twice through the kernel, as `models.ssm` chains the
SSD scan: from a zero state, for the block's final state and its per-key
log decay (the block's sum of log w); then, after the model group has
exchanged them (`distributed.gather_stack`) and each rank has folded its
entering state (`distributed.state_prefix`), from that state. The
gradient reaches the earlier blocks through the kernel's d_init_state and
d_state.
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
    r = cfg.rwkv
    return r, cfg.d_model // r.head_dim


def timemix_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    r, n_heads = _dims(cfg)
    d = cfg.d_model
    return {**{f"mix_{c}": (d,) for c in "rkvwg"},
            **{name: (d, d) for name in ("wr", "wk", "wv", "wg", "wo")},
            "w0": (d,), "decay_a": (d, r.decay_lora_rank), "decay_b": (r.decay_lora_rank, d),
            "bonus_u": (n_heads, r.head_dim), "ln_scale": (d,)}


def channelmix_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    d, f = cfg.d_model, cfg.d_ff
    return {"mix_k": (d,), "mix_r": (d,), "wk_c": (d, f), "wv_c": (f, d), "wr_c": (d, d)}


def _token_shift(x: torch.Tensor, shift_state: Optional[torch.Tensor]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Previous-token tensor; shift_state (B,1,D) is the last token of the
    previous segment (decode). Returns (x_prev, new_shift_state)."""
    if shift_state is None:
        shift_state = torch.zeros((x.shape[0], 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    prev = torch.cat([shift_state.to(x.dtype), x[:, :-1]], dim=1)
    return prev, x[:, -1:]


def _block_layout(cache: Optional[dict]):
    """The layout of a sequence block (`partitioning.seq_block`, outside
    decode), else None."""
    if cache is None and partitioning.seq_block() is not None:
        return partitioning.current_layout()
    return None


def _shift_state(x: torch.Tensor, cache: Optional[dict], lay) -> Optional[torch.Tensor]:
    """The row before x: the previous block's last (`distributed.
    halo_from_prev`) in a sequence block, the cache's shift in decode."""
    if lay is not None:
        return distributed.halo_from_prev(x, 1, lay)
    return None if cache is None else cache["shift"]


def _lerp(x: torch.Tensor, prev: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    return x + (prev - x) * mix.to(x.dtype)


def timemix_part(params: Params, x: torch.Tensor, cfg: ModelConfig, r: int = 0, m: int = 1, *,
                 cache: Optional[dict] = None) -> tuple[torch.Tensor, dict]:
    """The time mix of heads [r H/m, (r+1) H/m) (`rwkv_share("tm")`'s weights;
    r 0 of m 1: all of them), without collectives: (the heads' part of the
    output, which the m parts sum to, the cache: the shift (B,1,D) and the
    heads' wkv state (B,H/m,K,V)). cache: {"shift": (B,1,D), "wkv" of the
    same heads}."""
    from repro_torch.kernels import ops  # local import to avoid cycles

    rw, n_heads = _dims(cfg)
    hs, h = rw.head_dim, n_heads // m
    lo, hi = r * h * hs, (r + 1) * h * hs
    dt = cdtype(cfg)
    B, S, _ = x.shape
    lay = _block_layout(cache)
    prev, new_shift = _token_shift(x, _shift_state(x, cache, lay))

    xr = _lerp(x, prev, params["mix_r"])
    xk = _lerp(x, prev, params["mix_k"])
    xv = _lerp(x, prev, params["mix_v"])
    xw = _lerp(x, prev, params["mix_w"])
    xg = _lerp(x, prev, params["mix_g"])

    rr = xr @ params["wr"].to(dt)
    kk = xk @ params["wk"].to(dt)
    vv = xv @ params["wv"].to(dt)
    gg = xg @ params["wg"].to(dt)
    # data-dependent log decay (<0): -exp(w0 + tanh(xw A) B), in fp32, on
    # the heads' channels
    dd = torch.tanh(xw.float() @ params["decay_a"].float()) @ params["decay_b"][:, lo:hi].float()
    logw = -torch.exp(params["w0"][lo:hi].float() + dd)            # (B,S,D/m)

    heads = (rr.reshape(B, S, h, hs), kk.reshape(B, S, h, hs), vv.reshape(B, S, h, hs),
             logw.reshape(B, S, h, hs), params["bonus_u"][r * h:(r + 1) * h].float())
    if lay is not None:
        # the state chained over the blocks: this block's zero-start final
        # state and per-key log decay, every block's gathered, this rank's
        # prefix
        _, s_r = ops.rwkv6_mix(*heads)
        st = distributed.state_prefix(distributed.gather_stack(s_r, lay),
                                      distributed.gather_stack(heads[3].sum(dim=1), lay), lay.r)
        y, new_wkv = ops.rwkv6_mix(*heads, init_state=st)
    else:
        y, new_wkv = ops.rwkv6_mix(*heads, init_state=None if cache is None else cache["wkv"])
    # per-head groupnorm, then the silu(g) gate
    yf = y.float()
    mu = yf.mean(dim=-1, keepdim=True)
    var = (yf - mu).square().mean(dim=-1, keepdim=True)
    yf = (yf - mu) * torch.rsqrt(var + 1e-5)
    yf = yf.reshape(B, S, h * hs) * params["ln_scale"][lo:hi].float()
    y = (yf * F.silu(gg.float())).to(dt)
    out = y @ params["wo"].to(dt)
    return out, {"shift": new_shift, "wkv": new_wkv}


def timemix_apply(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  cache: Optional[dict] = None) -> tuple[torch.Tensor, dict]:
    """cache: {"shift": (B,1,D), "wkv": (B,H,K,V)}. Returns (out, new cache).
    With `wr` this rank's column shard: the rank's heads (`timemix_part`),
    its output summed over the model group, the cache's wkv its heads'."""
    if params["wr"].shape[-1] == cfg.d_model:
        return timemix_part(params, x, cfg, cache=cache)
    lay = partitioning.tp_layout(cfg)
    x = distributed.copy_to_model(x, lay.model_group)
    out, new_cache = timemix_part(params, x, cfg, lay.r, lay.m, cache=cache)
    return distributed.reduce_from_model(out, lay.model_group), new_cache


def channel_value(params: Params, xk: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """v = relu(xk Wk)^2 Wv over the d_ff of the weights given (all of it,
    or a rank's `rwkv_share("cm")`: its part of the sum)."""
    dt = cdtype(cfg)
    k = F.relu(xk @ params["wk_c"].to(dt)).square()
    return k @ params["wv_c"].to(dt)


def channel_gate(params: Params, xr: torch.Tensor, v: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    """sigmoid(xr Wr) v on the columns of `wr_c` given, v the summed value
    there."""
    rgate = torch.sigmoid((xr @ params["wr_c"].to(cdtype(cfg))).float())
    return (rgate * v.float()).to(cdtype(cfg))


def channelmix_apply(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                     cache: Optional[dict] = None) -> tuple[torch.Tensor, dict]:
    """cache: {"shift": (B,1,D)}. Returns (out, new cache). With `wk_c`
    this rank's column shard: v's partial sums over the rank's d_ff
    reduce-scattered over d_model, gated on the rank's columns, and the
    product all-gathered."""
    lay = None
    if params["wk_c"].shape[-1] != cfg.d_ff:
        lay = partitioning.tp_layout(cfg)
        x = distributed.copy_to_model(x, lay.model_group)
    prev, new_shift = _token_shift(x, _shift_state(x, cache, _block_layout(cache)))
    xk = _lerp(x, prev, params["mix_k"])
    xr = _lerp(x, prev, params["mix_r"])
    v = channel_value(params, xk, cfg)
    if lay is None:
        return channel_gate(params, xr, v, cfg), {"shift": new_shift}
    v = distributed.reduce_scatter_to_model(v, lay)
    out = channel_gate(params, xr, v, cfg)
    return distributed.gather_from_model(out, lay.model_group, lay.m, lay.r), {"shift": new_shift}


def rwkv_cache_shape(cfg: ModelConfig, batch: int,
                     device: Union[str, torch.device] = "cuda") -> dict:
    """One layer's zero decode cache: the shift states in the compute dtype,
    the wkv state in fp32."""
    r, n_heads = _dims(cfg)
    cdt = cdtype(cfg)
    return {"tm_shift": torch.zeros((batch, 1, cfg.d_model), dtype=cdt, device=device),
            "wkv": torch.zeros((batch, n_heads, r.head_dim, r.head_dim), dtype=torch.float32,
                               device=device),
            "cm_shift": torch.zeros((batch, 1, cfg.d_model), dtype=cdt, device=device)}
