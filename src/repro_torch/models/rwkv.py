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
  * the time mix (`wr`'s columns) runs on the rank's heads where "model"
    divides them: r, k, v, g and the log decay on its columns, the wkv
    scan, the per-head norm and the gate on its heads, and `wo`'s row
    shard's product summed over the model group (Megatron's g); its state
    is the rank's heads' (B, H/m, K, V). Where "model" divides d_model but
    not the heads (the reference pins r, k, v and g on their channels
    whatever the heads), it runs on the rank's d_model / m columns: r, k,
    v and g there, r, k and v all-gathered whole for the scan (their
    gradient reduce-scattered), the log decay from the whole LoRA, the
    scan and the norm on every head, the rank's columns of y gated and
    through `wo`'s row shard, summed as above but in fp32 (so is x's
    gradient under f: m exceeds the heads, and m bf16 partials summed
    drift); its state is every head's. The rank's products cost 5
    d_model^2 / m a token either way;
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
(the heads), `timemix_project` / `timemix_scan` / `timemix_gate_out` (the
columns) and the channel mix's `channel_value` / `channel_gate` are the
collective-free pieces of rank r of m, which `partitioning.rwkv_share`
cuts from whole weights.

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


def timemix_project(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    cache: Optional[dict] = None) -> dict:
    """The time mix's token shift, its five lerps and r, k, v and g on the
    columns of `wr`, `wk`, `wv` and `wg` given (all of them, or a rank's
    `rwkv_share("tm")` shard): {"r", "k", "v", "g": (B,S,D') in the compute
    dtype, "xw": the decay's lerped input (B,S,D), "shift": the new shift
    state (B,1,D)}."""
    dt = cdtype(cfg)
    prev, new_shift = _token_shift(x, _shift_state(x, cache, _block_layout(cache)))
    out = {c: _lerp(x, prev, params[f"mix_{c}"]) @ params[f"w{c}"].to(dt) for c in "rkvg"}
    return {**out, "xw": _lerp(x, prev, params["mix_w"]), "shift": new_shift}


def _log_decay(params: Params, xw: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """The data-dependent log decay (<0) on channels [lo, hi): -exp(w0 +
    tanh(xw A) B), in fp32, from the whole LoRA."""
    dd = torch.tanh(xw.float() @ params["decay_a"].float()) @ params["decay_b"][:, lo:hi].float()
    return -torch.exp(params["w0"][lo:hi].float() + dd)


def _wkv_normed(params: Params, rr, kk, vv, logw, cfg: ModelConfig, r: int, h: int,
                cache: Optional[dict]) -> tuple[torch.Tensor, torch.Tensor]:
    """The wkv scan of heads [r h, (r+1) h) on their r, k, v and log decay
    (B,S,h hs), then the per-head groupnorm: (y (B,S,h hs) fp32, the heads'
    final state)."""
    from repro_torch.kernels import ops  # local import to avoid cycles

    hs = cfg.rwkv.head_dim
    B, S, _ = rr.shape
    heads = (rr.reshape(B, S, h, hs), kk.reshape(B, S, h, hs), vv.reshape(B, S, h, hs),
             logw.reshape(B, S, h, hs), params["bonus_u"][r * h:(r + 1) * h].float())
    lay = _block_layout(cache)
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
    yf = y.float()
    mu = yf.mean(dim=-1, keepdim=True)
    var = (yf - mu).square().mean(dim=-1, keepdim=True)
    return ((yf - mu) * torch.rsqrt(var + 1e-5)).reshape(B, S, h * hs), new_wkv


def timemix_gate_out(params: Params, y: torch.Tensor, g: torch.Tensor, cfg: ModelConfig,
                     lo: int, hi: int) -> torch.Tensor:
    """Channels [lo, hi) of the normed wkv output y (fp32), times their
    `ln_scale` and silu of g there, through `wo`'s rows given (all of
    them, or a rank's row shard: its part of the output)."""
    dt = cdtype(cfg)
    yf = y * params["ln_scale"][lo:hi].float()
    return (yf * F.silu(g.float())).to(dt) @ params["wo"].to(dt)


def timemix_part(params: Params, x: torch.Tensor, cfg: ModelConfig, r: int = 0, m: int = 1, *,
                 cache: Optional[dict] = None) -> tuple[torch.Tensor, dict]:
    """The time mix of heads [r H/m, (r+1) H/m) (`rwkv_share("tm")`'s weights;
    r 0 of m 1: all of them), without collectives: (the heads' part of the
    output, which the m parts sum to, the cache: the shift (B,1,D) and the
    heads' wkv state (B,H/m,K,V)). cache: {"shift": (B,1,D), "wkv" of the
    same heads}."""
    _, n_heads = _dims(cfg)
    h = n_heads // m
    lo, hi = r * h * cfg.rwkv.head_dim, (r + 1) * h * cfg.rwkv.head_dim
    p = timemix_project(params, x, cfg, cache=cache)
    y, new_wkv = _wkv_normed(params, p["r"], p["k"], p["v"], _log_decay(params, p["xw"], lo, hi),
                             cfg, r, h, cache)
    return timemix_gate_out(params, y, p["g"], cfg, lo, hi), {"shift": p["shift"], "wkv": new_wkv}


def timemix_scan(params: Params, rr: torch.Tensor, kk: torch.Tensor, vv: torch.Tensor,
                 xw: torch.Tensor, cfg: ModelConfig, *, cache: Optional[dict] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The time mix's middle on every head, from whole r, k, v (B,S,D) and
    the decay's input: the log decay from the whole LoRA, the wkv scan and
    the per-head norm: (y (B,S,D) fp32, the wkv state (B,H,K,V)). A rank
    of the column layout runs it on r, k and v gathered whole and keeps
    its columns of y (`timemix_gate_out`)."""
    _, n_heads = _dims(cfg)
    return _wkv_normed(params, rr, kk, vv, _log_decay(params, xw, 0, cfg.d_model), cfg, 0,
                       n_heads, cache)


def _timemix_columns(params: Params, x: torch.Tensor, cfg: ModelConfig, lay, *,
                     cache: Optional[dict] = None) -> tuple[torch.Tensor, dict]:
    """The column layout of rank `lay.r`: r, k, v and g on its d_model/m
    columns, r, k and v all-gathered whole (`distributed.gather_seq` on the
    channels: their gradient reduce-scattered, summed over the model group
    before the rank's block is taken, since each rank's scan feeds only its
    columns of y and so sees a part of it), the decay, the scan and the
    norm on every head, the rank's columns of y gated and through `wo`'s
    row shard: its part of the output. The cache's wkv state is every
    head's."""
    p = timemix_project(params, x, cfg, cache=cache)
    rr, kk, vv = (distributed.gather_seq(p[c], lay, dim=-1) for c in "rkv")
    y, new_wkv = timemix_scan(params, rr, kk, vv, p["xw"], cfg, cache=cache)
    lo, hi = lay.shard_range(cfg.d_model)
    return (timemix_gate_out(params, y[..., lo:hi], p["g"], cfg, lo, hi),
            {"shift": p["shift"], "wkv": new_wkv})


def timemix_apply(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  cache: Optional[dict] = None) -> tuple[torch.Tensor, dict]:
    """cache: {"shift": (B,1,D), "wkv": (B,H,K,V)}. Returns (out, new cache).
    With `wr` this rank's column shard: where "model" divides the heads,
    the rank's heads (`timemix_part`), the cache's wkv its heads'; else its
    columns (`_timemix_columns`), the cache's wkv every head's, x's
    gradient and the output summed in fp32; either way its output summed
    over the model group."""
    if params["wr"].shape[-1] == cfg.d_model:
        return timemix_part(params, x, cfg, cache=cache)
    lay = partitioning.tp_layout(cfg)
    if lay.splits(_dims(cfg)[1]):
        x = distributed.copy_to_model(x, lay.model_group)
        out, new_cache = timemix_part(params, x, cfg, lay.r, lay.m, cache=cache)
        return distributed.reduce_from_model(out, lay.model_group), new_cache
    # m is more than the heads here (128 ranks at full width): m partials
    # added in bf16 drift from the whole about as far as bf16 compute is
    # from fp32, so f's and g's sums run in fp32 and round once
    dt = x.dtype
    x = distributed.copy_to_model(x.float(), lay.model_group).to(dt)
    out, new_cache = _timemix_columns(params, x, cfg, lay, cache=cache)
    return distributed.reduce_from_model(out.float(), lay.model_group).to(dt), new_cache


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
