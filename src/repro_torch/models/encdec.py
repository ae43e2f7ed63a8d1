"""Whisper-style encoder-decoder backbone, the audio family (counterpart of
`repro.models.encdec`).

The conv/mel frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings `enc_frames` (B, S_enc, d_model), and a learned
adapter (`frontend_adapter`) keeps a parameterised frontend boundary.
Positions are sinusoidal (no RoPE), norms LayerNorm, MLPs plain GELU. The
encoder's self-attention is non-causal; each decoder block runs causal
self-attention, cross-attention over the encoder output and the MLP. All of
them go through the flash kernel on the card. The decode cache holds per
decoder layer the self-attention k/v (padded to `pad_to`) and the cross k/v,
computed once at prefill; decode's cross-attention runs `ops.decode_attention`
over them. Parameter names mirror the reference's leaves
(`enc_blocks.<i>.attn.wq`, `dec_blocks.<i>.cross_attn.wk`,
`dec_blocks.<i>.ln3.bias`, `enc_norm.scale`); the reference stacks the
blocks on a leading axis and scans them, the port loops. On a sharded
step each block's weights are gathered where the block runs (`remat_call`,
`partitioning.gather_block`), as the reference's `constrain_param_tree`
keeps its gathers per layer. Under the "tp" layout the encoder's
attention, the decoder's self- and cross-attention run on the rank's heads
where "model" divides them (the cross k/v from the encoder output after
f), every MLP on its d_ff and the tied embedding and logits on the
vocabulary where they divide (`layers`); the decode cache's self and cross
k/v hold the rank's kv heads, or where the heads do not divide "model"
they stay on their sequence blocks (`partitioning.cache_block`, with
`cross=True` for the cross k/v): decode's self-attention combines the
ranks' parts over the self cache's blocks and its cross-attention over the
cross k/v's, every position valid (`layers.decode_blocks`). Under the
"fsdp_sp" layout (`seq_blocks`) each rank computes its block of the
frames and of the tokens, at absolute positions, on whole weights: the
encoder's attention over k and v gathered from every block, non-causal;
the decoder's self-attention causal with the block's query offset, its
cross-attention over k and v gathered from the encoder's blocks; the
decode cache's self and cross k/v on their sequence blocks, as the serve
step holds them.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Union

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import partitioning
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (MLP, Attention, Device, Embedding, Norm, shapes_only,
                                            _final_logits, _groups, _last_block, _param,
                                            _write_kv, dense_init, embed, init_attention,
                                            init_mlp, init_norms_and_biases, remat_call)
from repro_torch.utils import distributed

Params = Mapping[str, torch.Tensor]


def _sinusoid_at(pos: int, d: int, n: int, device: Union[str, torch.device]) -> torch.Tensor:
    """(n, d) sinusoidal embeddings of positions pos .. pos + n - 1, in fp32."""
    p = torch.arange(pos, pos + n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    inv = torch.exp(-math.log(10000.0) * dim / (d // 2))
    ang = p * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device: Device):
        super().__init__()
        self.ln1 = Norm(cfg, cfg.d_model, device)
        self.ln2 = Norm(cfg, cfg.d_model, device)
        self.attn = Attention(cfg, device)
        self.mlp = MLP(cfg, device)


class DecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device: Device):
        super().__init__()
        self.ln1 = Norm(cfg, cfg.d_model, device)
        self.ln2 = Norm(cfg, cfg.d_model, device)
        self.ln3 = Norm(cfg, cfg.d_model, device)
        self.self_attn = Attention(cfg, device)
        self.cross_attn = Attention(cfg, device)
        self.mlp = MLP(cfg, device)


class EncDec(nn.Module):
    def __init__(self, cfg: ModelConfig, device: Device):
        super().__init__()
        if cfg.family != "audio" or cfg.encdec is None:
            raise NotImplementedError(f"{cfg.name} ({cfg.family}) is not an encoder-decoder")
        self.cfg = cfg
        self.frontend_adapter = _param((cfg.d_model, cfg.d_model), cfg, device)
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, device)
                                        for _ in range(cfg.encdec.n_encoder_layers))
        self.enc_norm = Norm(cfg, cfg.d_model, device)
        self.embedding = Embedding(cfg, device)
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = Norm(cfg, cfg.d_model, device)

    def forward(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        return forward(self, batch, self.cfg)


def init_params(cfg: ModelConfig, seed: int = 0, device: Device = "cuda") -> EncDec:
    """Build the model on `device` with weights drawn from `seed`: the
    reference's distributions (dense fan-in weights, attention `wo` scaled by
    1/sqrt(2 L), N(0, 0.02) embedding, LayerNorm scale 1 and bias 0) from a
    `torch.Generator`, not JAX's values (load those through
    `convert.params_from_jax`). On the "meta" device, or under a
    `FakeTensorMode`, shapes only."""
    model = EncDec(cfg, device)
    if shapes_only(model, device):
        return model
    gen = torch.Generator(device=device).manual_seed(seed)
    dense = dense_init(gen)
    with torch.no_grad():
        dense(model.frontend_adapter)
        model.embedding.embed.normal_(0.0, 0.02, generator=gen)
        init_norms_and_biases(model)
        for a in ([b.attn for b in model.enc_blocks]
                  + [a for b in model.dec_blocks for a in (b.self_attn, b.cross_attn)]):
            init_attention(a, cfg, dense)
        for blk in (*model.enc_blocks, *model.dec_blocks):
            init_mlp(blk.mlp, cfg, dense)
    return model


def _blocks(groups: dict, prefix: str, n: int, parts: tuple[str, ...]) -> list[dict]:
    return [{part: groups.get(f"{prefix}.{i}.{part}", {}) for part in parts}
            for i in range(n)]


def _enc_blocks(groups: dict, cfg: ModelConfig) -> list[dict]:
    return _blocks(groups, "enc_blocks", cfg.encdec.n_encoder_layers,
                   ("ln1", "ln2", "attn", "mlp"))


def _dec_blocks(groups: dict, cfg: ModelConfig) -> list[dict]:
    return _blocks(groups, "dec_blocks", cfg.n_layers,
                   ("ln1", "ln2", "ln3", "self_attn", "cross_attn", "mlp"))


def seq_blocks(cfg: ModelConfig, dec_len: int, enc_len: int
               ) -> tuple[Optional[tuple[int, int]], Optional[tuple[int, int]]]:
    """This rank's blocks (lo, hi) of the decoder's tokens and the
    encoder's frames under the sequence-parallel layout
    (`partitioning.sp_range`), or (None, None): both whole where either is
    (cross-attention runs a decoder block over the encoder's blocks)."""
    dec, enc = partitioning.sp_range(cfg, dec_len), partitioning.sp_range(cfg, enc_len)
    return (dec, enc) if dec is not None and enc is not None else (None, None)


def encode(groups: dict, frames: torch.Tensor, cfg: ModelConfig,
           blk: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """The encoder over the frame embeddings: (B, S_enc, d_model), or over
    frames [lo, hi) of them (`blk`, a sequence block: non-causal attention
    over k and v gathered from every block) their rows of it."""
    dt = L.cdtype(cfg)
    lo, hi = (0, frames.shape[1]) if blk is None else blk
    with partitioning.in_block(blk):
        adapter = partitioning.gather_part(
            "", {"frontend_adapter": groups[""]["frontend_adapter"]}, cfg)["frontend_adapter"]
        x = frames[:, lo:hi].to(dt) @ adapter.to(dt)
        x = x + _sinusoid_at(lo, cfg.d_model, hi - lo, x.device).to(dt)[None]
        positions = torch.arange(lo, hi, device=x.device)[None, :]

        def body(blk_, xc, positions_):
            h, _ = L.attention_apply(blk_["attn"], L.norm_apply(blk_["ln1"], xc, cfg), cfg,
                                     positions=positions_, causal=False, use_rope=False)
            xc = xc + h
            return xc + L.mlp_apply(blk_["mlp"], L.norm_apply(blk_["ln2"], xc, cfg), cfg)

        for part in _enc_blocks(groups, cfg):
            x = remat_call(body, cfg, part, x, positions)
        return L.norm_apply(partitioning.gather_part("enc_norm", groups["enc_norm"], cfg), x,
                            cfg)


def _dec_block_apply(blk: dict, x: torch.Tensor, enc_out: Optional[torch.Tensor],
                     cfg: ModelConfig, *, positions: torch.Tensor,
                     cache: Optional[dict] = None):
    """Returns (y, self k/v, cross k/v). `cache` holds {"k", "v", "pos",
    "cross_k", "cross_v"} in decode (the self k/v written at pos in place;
    cross k/v None); None at train and prefill, where the cross k/v come
    from `enc_out`."""
    self_cache = None if cache is None else {"k": cache["k"], "v": cache["v"],
                                             "pos": cache["pos"]}
    h, self_kv = L.attention_apply(blk["self_attn"], L.norm_apply(blk["ln1"], x, cfg), cfg,
                                   positions=positions, cache=self_cache, use_rope=False)
    x = x + h
    xn = L.norm_apply(blk["ln2"], x, cfg)
    if cache is None:
        h, cross_kv = L.attention_apply(blk["cross_attn"], xn, cfg, positions=positions,
                                        causal=False, use_rope=False, x_cross=enc_out)
    else:
        h = _cross_decode(blk["cross_attn"], xn, cache["cross_k"], cache["cross_v"], cfg)
        cross_kv = None
    x = x + h
    x = x + L.mlp_apply(blk["mlp"], L.norm_apply(blk["ln3"], x, cfg), cfg)
    return x, self_kv, cross_kv


def _cross_decode(params: Params, xn: torch.Tensor, kx: torch.Tensor, vx: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Decode's cross-attention over the stored cross k/v (no growth, no
    mask): on the rank's heads where `wq` is its column shard (`wo`'s row
    shard's product summed over the model group), or over the rank's block
    of the cross k/v combined with the other ranks' (`partitioning.
    cache_block(.., cross=True)`), else over the whole."""
    from repro_torch.kernels import ops
    group = None
    if params["wq"].shape[-1] != cfg.n_heads * cfg.resolved_head_dim:
        group = partitioning.tp_layout(cfg).model_group
    q, _, _ = L._project_qkv(params, xn, xn, cfg)
    blk = partitioning.cache_block(kx.shape[1], cross=True)
    if blk is None:
        h = ops.decode_attention(q, kx, vx, kx.shape[1])
    else:
        h = L.decode_blocks(q, kx, vx, blk[1], blk)
    h = h.reshape(*h.shape[:-2], -1) @ params["wo"].to(L.cdtype(cfg))
    return h if group is None else distributed.reduce_from_model(h, group)


def _embed(groups: dict, tokens: torch.Tensor, pos: int, cfg: ModelConfig) -> torch.Tensor:
    x = embed(groups, tokens, cfg)
    return x + _sinusoid_at(pos, cfg.d_model, x.shape[1], x.device).to(x.dtype)[None]


def _decoder_inputs(groups: dict, tokens: torch.Tensor, cfg: ModelConfig,
                    blk: Optional[tuple[int, int]]) -> tuple[torch.Tensor, torch.Tensor]:
    """The embedded tokens of the block [lo, hi) (all for None) and their
    absolute positions."""
    lo, hi = (0, tokens.shape[1]) if blk is None else blk
    x = _embed(groups, tokens[:, lo:hi], lo, cfg)
    return x, torch.arange(lo, hi, device=x.device)[None, :]


def forward(model: Union[EncDec, Params], batch: dict, cfg: ModelConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Training forward of the model or of a mapping of its parameter names
    to tensors: (logits over the decoder positions, aux 0); under the
    sequence-parallel layout (`seq_blocks`) this rank's block's."""
    groups = _groups(model)
    dec_blk, enc_blk = seq_blocks(cfg, batch["tokens"].shape[1], batch["enc_frames"].shape[1])
    enc_out = encode(groups, batch["enc_frames"], cfg, enc_blk)
    with partitioning.in_block(dec_blk):
        x, positions = _decoder_inputs(groups, batch["tokens"], cfg, dec_blk)

        def body(blk, xc, enc, positions_):
            return _dec_block_apply(blk, xc, enc, cfg, positions=positions_)[0]

        for blk in _dec_blocks(groups, cfg):
            x = remat_call(body, cfg, blk, x, enc_out, positions)
        return (_final_logits(groups, x, cfg),
                torch.zeros((), dtype=torch.float32, device=x.device))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, pos: int = 0,
               device: Device = "cuda") -> dict:
    """Zero cache {"layers": {"k", "v": (L, B, max_len, K, hd), "cross_k",
    "cross_v": (L, B, enc_len, K, hd)}, "pos": int}, enc_len =
    `registry.whisper_enc_len(cfg, max_len)` (the reference's `_encdec_cache`;
    K this rank's kv heads under a "tp" layout that splits them)."""
    from repro_torch.models.registry import whisper_enc_len
    cdt = L.cdtype(cfg)
    hd = cfg.resolved_head_dim
    lens = {"k": max_len, "v": max_len, "cross_k": whisper_enc_len(cfg, max_len),
            "cross_v": whisper_enc_len(cfg, max_len)}
    kv = partitioning.local_kv_heads(cfg)
    return {"layers": {name: torch.zeros((cfg.n_layers, batch, n, kv, hd), dtype=cdt,
                                         device=device)
                       for name, n in lens.items()}, "pos": pos}


def prefill(model: EncDec, batch: dict, cfg: ModelConfig, pad_to: int = 0
            ) -> tuple[torch.Tensor, dict]:
    """Encode the frames and run the prompt: (last-position logits, cache)
    with the self k/v padded to max(S, pad_to), the cross k/v as the
    encoder gave them, and pos = S (under `partitioning.cache_sequence`,
    this rank's blocks of both). Under the sequence-parallel layout each
    rank runs its blocks of the frames and the prompt, and the
    last-position logits come from the last block's rank."""
    groups = _groups(model)
    S = batch["tokens"].shape[1]
    dec_blk, enc_blk = seq_blocks(cfg, S, batch["enc_frames"].shape[1])
    enc_out = encode(groups, batch["enc_frames"], cfg, enc_blk)
    with partitioning.in_block(dec_blk):
        x, positions = _decoder_inputs(groups, batch["tokens"], cfg, dec_blk)
        B = x.shape[0]
        max_len = max(S, pad_to)
        cdt = L.cdtype(cfg)
        hd = cfg.resolved_head_dim
        shape = (cfg.n_layers, B, max_len // partitioning.cache_ways(),
                 partitioning.local_kv_heads(cfg), hd)
        self_kv = {name: torch.zeros(shape, dtype=cdt, device=x.device) for name in ("k", "v")}
        cross = {"cross_k": [], "cross_v": []}
        n_enc = batch["enc_frames"].shape[1]
        cblk = partitioning.cache_block(n_enc // partitioning.cache_ways(cross=True), cross=True)
        for i, blk in enumerate(_dec_blocks(groups, cfg)):
            x, kv, cross_kv = _dec_block_apply(partitioning.gather_block(blk, cfg), x, enc_out,
                                               cfg, positions=positions)
            _write_kv(self_kv["k"][i], kv["k"])
            _write_kv(self_kv["v"][i], kv["v"])
            for name, t in (("cross_k", cross_kv["k"]), ("cross_v", cross_kv["v"])):
                cross[name].append(t if cblk is None else t[:, cblk[0]:cblk[1]])
        layers = {**self_kv, **{name: torch.stack(ts) for name, ts in cross.items()}}
        logits = _final_logits(groups, _last_block(x[:, -1:], dec_blk), cfg)
        return logits, {"layers": layers, "pos": S}


def decode(model: EncDec, cache: dict, batch: dict, cfg: ModelConfig
           ) -> tuple[torch.Tensor, dict]:
    """One decode step: batch["tokens"] (B, S_new) -> (logits, cache); the
    self k/v are written in place, the returned cache carries the advanced
    `pos`."""
    groups = _groups(model)
    pos = cache["pos"]
    x = _embed(groups, batch["tokens"], pos, cfg)
    S_new = x.shape[1]
    positions = pos + torch.arange(S_new, device=x.device)[None, :]
    layers = cache["layers"]
    for i, blk in enumerate(_dec_blocks(groups, cfg)):
        x, _, _ = _dec_block_apply(partitioning.gather_block(blk, cfg), x, None, cfg,
                                   positions=positions,
                                   cache={**{name: t[i] for name, t in layers.items()},
                                          "pos": pos})
    return _final_logits(groups, x, cfg), {**cache, "pos": pos + S_new}
