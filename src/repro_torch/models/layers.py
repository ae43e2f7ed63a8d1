"""Core neural-net layers as plain functions on tensors (counterpart of
`repro.models.layers`).

Conventions:
* each layer takes its parameters as a mapping of leaf name -> tensor, with
  the reference's leaf names (wq/wk/wv/wo/wi/wg/wo_mlp/embed/scale/bias);
  `transformer.py` holds them in `nn.Module`s and passes each module's
  parameters (`params_of(module)`, or views of a flat buffer in training);
* compute runs in `cfg.compute_dtype` (bf16 at full width); parameters are
  stored in `cfg.param_dtype` (fp32 master copies) and cast at use;
* the reference's `constrain` calls pin GSPMD's layout; the port computes
  that layout itself. Under a tensor-parallel layout
  (`partitioning.tp_layout`) a layer is handed this rank's column or row
  shard of a weight (`partitioning.gather_part`) and reads its layout from
  the shapes: attention on its local heads (`wq`'s columns), the MLP on its
  local d_ff, the embedding and logits on its local vocabulary, with
  Megatron's f (`distributed.copy_to_model`) on a column-parallel product's
  input and g (`distributed.reduce_from_model`) on a row-parallel product's
  output. Under the sequence-parallel layout (`partitioning.seq_block`) x
  is this rank's block of the sequence: attention gathers k and v whole
  over the model group (`distributed.gather_seq`; cross-attention's from
  the encoder output's blocks) and runs the flash kernel with the block's
  query offset; decode over a cache split on the sequence
  (`partitioning.cache_block`) combines the ranks' parts
  (`distributed.lse_combine`). With whole weights (no layout, or a module
  this port does not shard) the code is the meshless one. With
  `weight_stream_bf16` the blocks' >=2-D weights reach this code already
  in the compute dtype (`partitioning.stream_cast`, applied where a block's
  parameters are taken: `transformer._block`).
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import partitioning
from repro_torch.models.config import ModelConfig
from repro_torch.utils import distributed

Params = Mapping[str, torch.Tensor]


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def params_of(module: nn.Module) -> dict[str, torch.Tensor]:
    """A module's own parameters by leaf name (not its children's)."""
    return dict(module.named_parameters(recurse=False))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_shapes(cfg: ModelConfig, d: int) -> dict[str, tuple[int, ...]]:
    if cfg.norm == "rmsnorm":
        return {"scale": (d,)}
    if cfg.norm == "layernorm":
        return {"scale": (d,), "bias": (d,)}
    if cfg.norm == "nonparam_ln":      # OLMo: non-parametric LayerNorm
        return {}
    raise ValueError(cfg.norm)


def norm_apply(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + 1e-6)
        y = y * params["scale"].float()
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
        if cfg.norm == "layernorm":
            y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def rms_norm_headwise(x: torch.Tensor) -> torch.Tensor:
    """Parameter-free RMS over the trailing (head) dim — qwen3 qk_norm."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + 1e-6)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)                # (hd/2,)
    angles = positions[..., None].float() * freqs                 # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                         # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    # gather, then cast: the same values as the reference's cast-then-gather
    # without casting the whole table
    table = params["embed"]
    if table.shape[0] == cfg.vocab_size:
        return table[tokens.long()].to(cdtype(cfg))
    # vocab-parallel: this rank's rows of the table, the other ranks' tokens
    # zero, summed over the model group (each token has one owner)
    lay = partitioning.tp_layout(cfg)
    lo, hi = lay.shard_range(cfg.vocab_size)
    tok = tokens.long()
    mine = (tok >= lo) & (tok < hi)
    x = table[(tok - lo).clamp(0, hi - lo - 1)].to(cdtype(cfg)) * mine[..., None].to(cdtype(cfg))
    return distributed.reduce_from_model(x, lay.model_group)


def logits_apply(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The logits; over this rank's vocabulary shard when the head is
    vocab-sharded (`registry.vocab_parallel_cross_entropy` reduces them over
    "model")."""
    if cfg.tie_embeddings:
        w = params["embed"].to(cdtype(cfg)).T
    else:
        w = params["unembed"].to(cdtype(cfg))
    if w.shape[-1] != cfg.vocab_size:
        x = distributed.copy_to_model(x, partitioning.tp_layout(cfg).model_group)
    logits = x @ w
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits.float() / c).to(logits.dtype)
    return logits


# ---------------------------------------------------------------------------
# Gated / plain MLP
# ---------------------------------------------------------------------------

def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu":
        return F.relu(x)
    if kind == "relu2":
        return F.relu(x).square()
    raise ValueError(kind)


def mlp_apply(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A column-parallel `wi` / `wg` and a row-parallel `wo_mlp` when the
    weights are this rank's d_ff shards."""
    dt = cdtype(cfg)
    group = None
    if params["wi"].shape[-1] != cfg.d_ff:
        group = partitioning.tp_layout(cfg).model_group
        x = distributed.copy_to_model(x, group)
    h = _act(x @ params["wi"].to(dt), cfg.act)
    if cfg.mlp_gated:
        h = h * (x @ params["wg"].to(dt))
    out = h @ params["wo_mlp"].to(dt)
    return out if group is None else distributed.reduce_from_model(out, group)


# ---------------------------------------------------------------------------
# Attention (MHA / GQA / MQA) with optional cache
# ---------------------------------------------------------------------------

def _project_qkv(params: Params, xq: torch.Tensor, xkv: torch.Tensor, cfg: ModelConfig):
    """q, k, v on the heads of the weights given: all of them, or this
    rank's column shards' under a tensor-parallel layout."""
    dt = cdtype(cfg)
    hd = cfg.resolved_head_dim
    q = xq @ params["wq"].to(dt)
    k = xkv @ params["wk"].to(dt)
    v = xkv @ params["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = q.reshape(*q.shape[:-1], -1, hd)
    k = k.reshape(*k.shape[:-1], -1, hd)
    v = v.reshape(*v.shape[:-1], -1, hd)
    return q, k, v


def kv_head_of(h_loc: int, cfg: ModelConfig, r: int) -> int:
    """The kv head that query heads [r h_loc, (r+1) h_loc) attend with when
    n_kv_heads does not divide "model" (gemma's 1, qwen3's and mixtral's 8
    on 16): one group of n_heads / n_kv_heads query heads holds them all."""
    g = cfg.n_heads // cfg.n_kv_heads
    lo = r * h_loc // g
    if ((r + 1) * h_loc - 1) // g != lo:
        raise NotImplementedError(f"{cfg.name}: query heads [{r * h_loc}, {(r + 1) * h_loc}) "
                                  f"span more than one kv group of {g}")
    return lo


def _kv_head(t: torch.Tensor, head: Optional[int]) -> torch.Tensor:
    return t if head is None else t.narrow(-2, head, 1).contiguous()


def decode_attention_part(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid_len: int,
                          kv_offset: int, window: Optional[int] = None
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One rank's part of `ref.decode_attention_plain` over its block of a
    cache, the keys at positions kv_offset .. kv_offset + k.shape[1] - 1,
    with the same validity and window masks: (row max m (B,K,G,Sq), l = sum
    exp(s - m), o = sum exp(s - m) v (B,K,G,Sq,hd_v)) in fp32, for
    `distributed.lse_combine`."""
    b, sq, h, hd = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(b, sq, n_kv, h // n_kv, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(hd)
    kpos = kv_offset + torch.arange(k.shape[1], device=q.device)
    mask = kpos < valid_len
    if window is not None:
        mask &= kpos > valid_len - 1 - window
    s = torch.where(mask, s, -1e30)
    m = s.amax(dim=-1)
    # a block that no query sees (past the valid entries, or before the
    # window) gives l = 0 and o = 0, and weighs 0 in the combine
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    return m, p.sum(dim=-1), torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())


def write_positions(t: torch.Tensor, new: torch.Tensor, pos: int, lo: int = 0) -> None:
    """Cache tensor t (B, n, ...) holds positions lo .. lo + n - 1: write
    into it the part of `new` (B, s, ...), positions pos .. pos + s - 1,
    that falls there (in place)."""
    a, e = max(pos, lo), min(pos + new.shape[1], lo + t.shape[1])
    if a < e:
        t[:, a - lo:e - lo] = new[:, a - pos:e - pos].to(t.dtype)


def decode_blocks(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor, valid_len: int,
                  blk: tuple, window: Optional[int] = None, lay=None) -> torch.Tensor:
    """Decode attention of q over this rank's block [lo, hi) of a cache
    split on the sequence over `group` (`blk` = (lo, hi, group)): each
    rank's part over its block, the parts combined over the group. Under
    the tensor-parallel layout `lay` (q this rank's heads, the cache every
    kv head) the queries of every head are gathered over the model group
    first, and the rank's heads kept after. Returns (B,Sq,H_q,hd_v)."""
    lo, _, group = blk
    h_loc = q.shape[2]
    if lay is not None:
        q = distributed.all_heads(q, lay)
    m, l, o = decode_attention_part(q, kc, vc, valid_len, lo, window=window)
    out = distributed.lse_combine(m, l, o, group)                 # (B,K,G,Sq,hd_v)
    b, n_kv, g, sq, hd_v = out.shape
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, n_kv * g, hd_v).to(q.dtype)
    if lay is not None:
        out = out.narrow(2, lay.r * h_loc, h_loc)
    return out


def _decode_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache: dict,
                    blk: tuple, cfg: ModelConfig, lay=None) -> tuple[torch.Tensor, dict]:
    """Decode over this rank's block [lo, hi) of a cache split on the
    sequence over `group`: the new k/v written by the rank whose block
    holds their positions, then `decode_blocks`. Returns (out
    (B,Sq,H_q,hd_v), the cache)."""
    pos, s_new = cache["pos"], q.shape[1]
    kc, vc = cache["k"], cache["v"]
    write_positions(kc, k, pos, blk[0])
    write_positions(vc, v, pos, blk[0])
    out = decode_blocks(q, kc, vc, pos + s_new, blk, cfg.sliding_window, lay)
    return out, {"k": kc, "v": vc, "pos": pos + s_new}


def attention_apply(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor,
                    causal: bool = True,
                    use_rope: bool = True,
                    cache: Optional[dict] = None,
                    x_cross: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, dict]:
    """Self- or cross-attention.

    x: (B, S, D). `cache` (decode): {"k": (B, S_max, K, hd), "v": ..., "pos": int}
    — new k/v are written at `pos` IN PLACE (the reference returns an updated
    copy; writing into the cache saves a cache-sized copy per layer and step),
    and attention runs over the full cache with a validity mask. Returns
    (out, cache): the updated cache, or this segment's k/v without a cache.

    With `wq` this rank's column shard (a tensor-parallel layout) the heads
    are this rank's H/m: q, k and v come from the local column shards (k and
    v of all K heads where K does not divide "model", of which the local
    query heads take theirs, `kv_head_of`), the kernels run on the local
    heads, and `wo`'s row shard's product is summed over the model group.

    Under a sequence block (`partitioning.seq_block`, x this rank's block
    [lo, hi) and `positions` absolute) self-attention gathers k and v whole
    over the model group and the flash kernel runs with q_offset lo;
    cross-attention likewise, `x_cross` this rank's block of the encoder
    output (the encoder-decoder computes the two sequences on blocks
    together, `encdec`); the returned k/v are the whole sequence's. Decode
    over a cache split on the sequence (`partitioning.cache_block` of its
    length; under "fsdp_sp", or under "tp" where the kv heads do not carry
    the cache) is `_decode_sharded`.
    """
    from repro_torch.kernels import ops  # local import to avoid cycles

    hd = cfg.resolved_head_dim
    lay, kv_head = None, None
    if params["wq"].shape[-1] != cfg.n_heads * hd:
        lay = partitioning.tp_layout(cfg)
        x = distributed.copy_to_model(x, lay.model_group)
        if x_cross is not None:
            x_cross = distributed.copy_to_model(x_cross, lay.model_group)
        if params["wk"].shape[-1] == cfg.n_kv_heads * hd:
            kv_head = kv_head_of(params["wq"].shape[-1] // hd, cfg, lay.r)
    xkv = x if x_cross is None else x_cross
    q, k, v = _project_qkv(params, x, xkv, cfg)
    if cfg.qk_norm:
        q, k = rms_norm_headwise(q), rms_norm_headwise(k)
    if use_rope and x_cross is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    blk = partitioning.seq_block()
    cblk = partitioning.cache_block(cache["k"].shape[1]) if cache is not None else None
    if cblk is not None and x_cross is None:
        out, new_cache = _decode_sharded(q, k, v, cache, cblk, cfg, lay)
    elif cache is not None and x_cross is None:
        # decode: write new kv at cache["pos"], attend over the cache
        pos, s_new = cache["pos"], x.shape[1]
        kc, vc = cache["k"], cache["v"]
        kc[:, pos:pos + s_new] = k.to(kc.dtype)
        vc[:, pos:pos + s_new] = v.to(vc.dtype)
        out = ops.decode_attention(q, _kv_head(kc, kv_head), _kv_head(vc, kv_head),
                                   pos + s_new, window=cfg.sliding_window)
        new_cache = {"k": kc, "v": vc, "pos": pos + s_new}
    else:
        q_offset = 0
        if blk is not None:
            here = partitioning.current_layout()
            k, v = distributed.gather_seq(k, here), distributed.gather_seq(v, here)
            q_offset = blk[0]
        out = ops.flash_attention(q, _kv_head(k, kv_head), _kv_head(v, kv_head),
                                  causal=causal and x_cross is None, window=cfg.sliding_window,
                                  q_offset=q_offset)
        # expose this segment's k/v so prefill can build the decode cache
        new_cache = {"k": k, "v": v}

    out = out.reshape(*out.shape[:-2], -1)
    out = out @ params["wo"].to(cdtype(cfg))
    return (out if lay is None else distributed.reduce_from_model(out, lay.model_group),
            new_cache)
