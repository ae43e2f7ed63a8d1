"""RWKV6 ("Finch") blocks: time-mix with data-dependent decay + channel-mix
(counterpart of `repro.models.rwkv`).

The wkv recurrence goes through `repro_torch.kernels.ops.rwkv6_mix` (the
Hopper kernel on the card). Token-shift lerps use static per-channel mix
coefficients; the decay w is data-dependent through a low-rank MLP and is
computed in fp32. Decode carries the shift states (compute dtype) and the
per-head wkv state (fp32). Parameters are mappings of the reference's leaf
names to tensors, as in `layers.py`.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, cdtype


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


def _lerp(x: torch.Tensor, prev: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    return x + (prev - x) * mix.to(x.dtype)


def timemix_apply(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  cache: Optional[dict] = None) -> tuple[torch.Tensor, dict]:
    """cache: {"shift": (B,1,D), "wkv": (B,H,K,V)}. Returns (out, new cache)."""
    from repro_torch.kernels import ops  # local import to avoid cycles

    r, n_heads = _dims(cfg)
    dt = cdtype(cfg)
    B, S, D = x.shape
    prev, new_shift = _token_shift(x, None if cache is None else cache["shift"])

    xr = _lerp(x, prev, params["mix_r"])
    xk = _lerp(x, prev, params["mix_k"])
    xv = _lerp(x, prev, params["mix_v"])
    xw = _lerp(x, prev, params["mix_w"])
    xg = _lerp(x, prev, params["mix_g"])

    rr = xr @ params["wr"].to(dt)
    kk = xk @ params["wk"].to(dt)
    vv = xv @ params["wv"].to(dt)
    gg = xg @ params["wg"].to(dt)
    # data-dependent log decay (<0): -exp(w0 + tanh(xw A) B), in fp32
    dd = torch.tanh(xw.float() @ params["decay_a"].float()) @ params["decay_b"].float()
    logw = -torch.exp(params["w0"].float() + dd)                   # (B,S,D)

    hs = r.head_dim
    y, new_wkv = ops.rwkv6_mix(rr.reshape(B, S, n_heads, hs), kk.reshape(B, S, n_heads, hs),
                               vv.reshape(B, S, n_heads, hs), logw.reshape(B, S, n_heads, hs),
                               params["bonus_u"].float(),
                               init_state=None if cache is None else cache["wkv"])
    # per-head groupnorm, then the silu(g) gate
    yf = y.float()
    mu = yf.mean(dim=-1, keepdim=True)
    var = (yf - mu).square().mean(dim=-1, keepdim=True)
    yf = (yf - mu) * torch.rsqrt(var + 1e-5)
    yf = yf.reshape(B, S, D) * params["ln_scale"].float()
    y = (yf * F.silu(gg.float())).to(dt)
    out = y @ params["wo"].to(dt)
    return out, {"shift": new_shift, "wkv": new_wkv}


def channelmix_apply(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                     cache: Optional[dict] = None) -> tuple[torch.Tensor, dict]:
    """cache: {"shift": (B,1,D)}. Returns (out, new cache)."""
    dt = cdtype(cfg)
    prev, new_shift = _token_shift(x, None if cache is None else cache["shift"])
    xk = _lerp(x, prev, params["mix_k"])
    xr = _lerp(x, prev, params["mix_r"])
    k = F.relu(xk @ params["wk_c"].to(dt)).square()
    v = k @ params["wv_c"].to(dt)
    rgate = torch.sigmoid((xr @ params["wr_c"].to(dt)).float())
    out = (rgate * v.float()).to(dt)
    return out, {"shift": new_shift}


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
