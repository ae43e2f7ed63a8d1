"""Decoder-LM assembly for the dense, moe, vlm, ssm (rwkv6) and hybrid
(zamba2) families (counterpart of `repro.models.transformer`; the audio
family's encoder-decoder is `encdec.py`).

Parameters live in `nn.Module`s whose names mirror the reference's leaves
(`embedding.embed`, `blocks.<i>.attn.wq`, `blocks.<i>.mlp.wi|wg|wo_mlp`; for
rwkv6 `blocks.<i>.tm.wr`, `blocks.<i>.cm.wk_c`, `blocks.<i>.ln1.scale`; for
zamba2 `blocks.<i>.mixer.wz`, `blocks.<i>.ln.scale`, `shared.attn.wq` and
`lora.attn_a`, whose leading axis is the shared block's invocation, as the
reference stacks it); the reference stacks the blocks on a leading L axis
and scans them, the port keeps one module per block and loops. Entry points:

    forward(model_or_params, batch, cfg)    -> (logits, aux_loss)
    prefill(model, batch, cfg, pad_to)      -> (last_logits, cache)
    decode(model, cache, batch, cfg)        -> (logits, cache)

`forward` takes the model or a mapping of its parameter names to tensors
(the training step passes leaf views of a flat buffer). Under autograd,
`cfg.remat` checkpoints each block as the reference's `_remat` does:
"none" saves everything, "full" saves the block's input only
(`torch.utils.checkpoint`), "dots" saves the outputs of the matrix products
without batch dims (`aten.mm`: the projections) and recomputes the rest,
the counterpart of `dots_with_no_batch_dims_saveable`. Serving runs under
`torch.inference_mode()` and checkpoints nothing. An rwkv6 decode cache
holds, per layer, the two token-shift states and the wkv state, and has no
sequence axis (prefill ignores `pad_to`, as the reference's does). A zamba2
model runs the shared attention block (its LoRA of the invocation) before
every `hybrid.period` mamba blocks; only the mamba blocks are checkpointed,
as the reference's `_remat` wraps them alone. Its decode cache holds, per
mamba layer, the two conv tails and the SSM state, and per invocation of the
shared block its k/v. A moe block takes the MoE feed-forward
(`blocks.<i>.moe.router|we_in|we_gate|we_out`, `blocks.<i>.moe.shared.wi`)
and, where `cfg.mla` is set, MLA attention (`blocks.<i>.attn.w_dkv`, ...);
deepseek's first `moe.first_dense_layers` layers are `dense_blocks.<j>`, a
gated MLP of width `moe.dense_d_ff` (the reference keeps them as a list, not
stacked); `forward` returns the MoE aux loss summed over the layers. Its MLA
cache holds the compressed latent {"c_kv", "k_rope"} per layer, and the dense
layers' caches are the list "dense_layers". A vlm model projects the
precomputed patch embeddings (`batch["patch_embeds"]`, `projector`) over the
first `vision.n_image_tokens` positions.

On a sharded step the parameters come as DTensors and each block's are
gathered where the block runs (`partitioning.gather_block`, inside
`remat_call`'s checkpointed function, so at most one block's gathered
weights are live at a time outside remat="none"); the embedding, the
output head, the vlm projector and zamba2's shared block and LoRA where
they are used. Under the "tp" profile's layout the attention (MLA too),
MLP, MoE experts, rwkv6's time and channel mixes, embedding and logits
compute tensor-parallel over "model" (`layers`, `mla`, `moe`, `rwkv`): a
moe block's "moe" part comes as the rank's expert share (EP's experts or
expert TP's d_ff) with its shared experts on their d_ff; the logits come
back vocab-sharded; the cache holds this rank's kv heads where both head
counts divide "model", else it stays on its sequence blocks
(`partitioning.cache_block`), as under "fsdp_sp"; an rwkv6 cache holds
the rank's heads of the wkv state and the whole token shifts. zamba2's
mamba blocks run on the rank's heads (`ssm`), its shared block's
attention and MLP tensor-parallel with the invocation's LoRA added once,
after their sums (each rank computes it whole on the block's normed
input, outside f); its cache holds the rank's x-conv channels and SSM
heads.
Under the "fsdp_sp" profile's layout (`partitioning.sequence_block`) each
rank computes its block of the sequence, at absolute positions, on whole
weights (a vlm's block of the image-prefixed sequence, its projector run
on the image positions the block holds): `forward` returns the block's
logits; `prefill` writes the part of the gathered k/v (MLA's latents, the
blocks' gathered) that falls in its block of the cache
(`partitioning.cache_block`; the whole cache without one) and takes the
last position's hidden state and the mamba and rwkv6 layers' final
states from the last block (`distributed.broadcast_from`); `decode` runs
the new token whole on each rank, attention over the rank's part of the
cache.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Mapping, Optional, Union

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import partitioning
from repro_torch.models import rwkv as RWKV
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig
from repro_torch.utils import distributed

Device = Union[str, torch.device]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a config this module does not assemble: dense and vlm (a
    vision config) without MoE, moe with a MoE config (MLA or not), ssm with
    an rwkv config (rwkv6) and hybrid with ssm and hybrid configs (zamba2).
    The audio family is `encdec`'s."""
    ok = {"dense": cfg.moe is None,
          "vlm": cfg.moe is None and cfg.vision is not None,
          "moe": cfg.moe is not None,
          "ssm": cfg.rwkv is not None,
          "hybrid": cfg.ssm is not None and cfg.hybrid is not None}.get(cfg.family, False)
    if not ok:
        raise NotImplementedError(f"{cfg.name} ({cfg.family}) is not a decoder-LM config "
                                  f"of the dense, moe, vlm, ssm or hybrid families")


def dense_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config of a moe model's leading dense layers: d_ff = dense_d_ff."""
    return dataclasses.replace(cfg, d_ff=cfg.moe.dense_d_ff or cfg.d_ff)


def n_dense(cfg: ModelConfig) -> int:
    """Leading dense layers of a moe model (deepseek's first layer), else 0."""
    return cfg.moe.first_dense_layers if cfg.moe is not None else 0


# ---------------------------------------------------------------------------
# Parameter containers
# ---------------------------------------------------------------------------

def _param(shape, cfg: ModelConfig, device: Device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=L.pdtype(cfg), device=device))


class Shaped(nn.Module):
    """A module whose parameters are given by name and shape."""

    def __init__(self, shapes: dict[str, tuple[int, ...]], cfg: ModelConfig, device: Device):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, _param(shape, cfg, device))


class Norm(Shaped):
    def __init__(self, cfg: ModelConfig, d: int, device: Device):
        super().__init__(L.norm_shapes(cfg, d), cfg, device)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device: Device):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        self.wq = _param((d, cfg.n_heads * hd), cfg, device)
        self.wk = _param((d, cfg.n_kv_heads * hd), cfg, device)
        self.wv = _param((d, cfg.n_kv_heads * hd), cfg, device)
        self.wo = _param((cfg.n_heads * hd, d), cfg, device)
        if cfg.qkv_bias:
            self.bq = _param((cfg.n_heads * hd,), cfg, device)
            self.bk = _param((cfg.n_kv_heads * hd,), cfg, device)
            self.bv = _param((cfg.n_kv_heads * hd,), cfg, device)


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device: Device):
        super().__init__()
        self.wi = _param((cfg.d_model, cfg.d_ff), cfg, device)
        self.wo_mlp = _param((cfg.d_ff, cfg.d_model), cfg, device)
        if cfg.mlp_gated:
            self.wg = _param((cfg.d_model, cfg.d_ff), cfg, device)


class MoE(Shaped):
    def __init__(self, cfg: ModelConfig, device: Device):
        super().__init__(MOE.moe_shapes(cfg), cfg, device)
        if cfg.moe.n_shared_experts:
            self.shared = Shaped(MOE.shared_shapes(cfg), cfg, device)


class Block(nn.Module):
    """An attention block: MHA/GQA or, where `cfg.mla` is set, MLA; a gated
    MLP or, with `use_moe`, the MoE feed-forward."""

    def __init__(self, cfg: ModelConfig, device: Device, use_moe: bool = False):
        super().__init__()
        self.ln1 = Norm(cfg, cfg.d_model, device)
        self.ln2 = Norm(cfg, cfg.d_model, device)
        self.attn = (Shaped(MLA.mla_shapes(cfg), cfg, device) if cfg.mla is not None
                     else Attention(cfg, device))
        if use_moe:
            self.moe = MoE(cfg, device)
        else:
            self.mlp = MLP(cfg, device)


class RWKVBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device: Device):
        super().__init__()
        self.ln1 = Norm(cfg, cfg.d_model, device)
        self.ln2 = Norm(cfg, cfg.d_model, device)
        self.tm = Shaped(RWKV.timemix_shapes(cfg), cfg, device)
        self.cm = Shaped(RWKV.channelmix_shapes(cfg), cfg, device)


class MambaBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device: Device):
        super().__init__()
        self.ln = Norm(cfg, cfg.d_model, device)
        self.mixer = Shaped(SSM.mamba2_shapes(cfg), cfg, device)


def _n_shared_invocations(cfg: ModelConfig) -> int:
    return (cfg.n_layers + cfg.hybrid.period - 1) // cfg.hybrid.period


def lora_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The shared block's per-invocation LoRA, stacked on the invocation
    axis as the reference's leaves are."""
    n, d, r = _n_shared_invocations(cfg), cfg.d_model, cfg.hybrid.lora_rank
    return {"attn_a": (n, d, r), "attn_b": (n, r, d), "mlp_a": (n, d, r), "mlp_b": (n, r, d)}


class Embedding(nn.Module):
    def __init__(self, cfg: ModelConfig, device: Device):
        super().__init__()
        self.embed = _param((cfg.vocab_size, cfg.d_model), cfg, device)
        if not cfg.tie_embeddings:
            self.unembed = _param((cfg.d_model, cfg.vocab_size), cfg, device)


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, device: Device):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embedding = Embedding(cfg, device)
        self.final_norm = Norm(cfg, cfg.d_model, device)
        if cfg.family == "moe":
            if n_dense(cfg):
                self.dense_blocks = nn.ModuleList(Block(dense_cfg(cfg), device)
                                                  for _ in range(n_dense(cfg)))
            self.blocks = nn.ModuleList(Block(cfg, device, use_moe=True)
                                        for _ in range(cfg.n_layers - n_dense(cfg)))
        else:
            block = {"ssm": RWKVBlock, "hybrid": MambaBlock}.get(cfg.family, Block)
            self.blocks = nn.ModuleList(block(cfg, device) for _ in range(cfg.n_layers))
        if cfg.family == "hybrid":
            self.shared = Block(cfg, device)
            self.lora = Shaped(lora_shapes(cfg), cfg, device)
        if cfg.vision is not None:
            self.projector = _param((cfg.vision.clip_dim, cfg.d_model), cfg, device)

    def forward(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        return forward(self, batch, self.cfg)


def init_params(cfg: ModelConfig, seed: int = 0, device: Device = "cuda") -> Transformer:
    """Build the model on `device` with weights drawn from `seed`.

    The same distributions as the reference's init (truncated-normal fan-in
    dense weights, N(0, 0.02) embedding, `wo` scaled by 1/sqrt(2 L), unit norm
    scales, zero biases; rwkv6's token-shift mixes 0.5, decay base w0 -2,
    `decay_b` scaled by 0.1, bonus u ~ 0.1 N(0, 1); zamba2's conv weights
    N(0, 1) / sqrt(d_conv), a_log = log(linspace(1, 16, H)), d_skip 1,
    dt_bias = log(expm1(0.01)), `w_out` scaled by 1/sqrt(2 L), LoRA `a`
    dense per invocation and `b` zero; the router, each expert's weights and
    the shared experts, MLA's projections and the vlm projector dense, MLA's
    `wo` scaled by 1/sqrt(2 L), its kv norm scale 1), drawn from a
    `torch.Generator` on `device`: the values differ from JAX's. To hold the
    port against the reference, load the JAX init through
    `convert.params_from_jax`. On the "meta" device, or under a
    `FakeTensorMode` (`utils.abstract`), the parameters get shapes only.
    """
    model = Transformer(cfg, device)
    if shapes_only(model, device):
        return model
    gen = torch.Generator(device=device).manual_seed(seed)
    dense = dense_init(gen)
    with torch.no_grad():
        model.embedding.embed.normal_(0.0, 0.02, generator=gen)
        if not cfg.tie_embeddings:
            dense(model.embedding.unembed)
        init_norms_and_biases(model)
        for blk in model.blocks:
            if cfg.family == "ssm":
                _init_rwkv_block(blk, cfg, dense, gen)
            elif cfg.family == "hybrid":
                _init_mamba_block(blk, cfg, dense, gen)
            else:
                _init_attn_block(blk, cfg, dense)
        for blk in getattr(model, "dense_blocks", ()):
            _init_attn_block(blk, dense_cfg(cfg), dense)
        if cfg.vision is not None:
            dense(model.projector)
        if cfg.family == "hybrid":
            _init_attn_block(model.shared, cfg, dense)
            lora = model.lora
            for i in range(lora.attn_a.shape[0]):
                dense(lora.attn_a[i])
                dense(lora.mlp_a[i])
            lora.attn_b.zero_()
            lora.mlp_b.zero_()
    return model


def shapes_only(model: nn.Module, device: Device) -> bool:
    """Whether the model's parameters hold no data to draw: on the "meta"
    device, or fake (made under a FakeTensorMode)."""
    from repro_torch.utils import abstract
    return torch.device(device).type == "meta" or abstract.is_fake(next(model.parameters()))


def dense_init(gen: torch.Generator):
    """The reference's dense initialiser, drawing from `gen`: w ~ truncated
    N(0, 1) on [-2, 2], times scale / sqrt(fan-in)."""
    def dense(w: torch.Tensor, scale: float = 1.0) -> None:
        nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=gen)
        w.mul_(scale / math.sqrt(w.shape[0]))
    return dense


def init_norms_and_biases(model: nn.Module) -> None:
    """Every norm scale (MLA's `kv_norm_scale` too) to 1, every bias to 0."""
    for name, p in model.named_parameters():
        if name.endswith("scale"):
            p.fill_(1.0)
        elif name.endswith(("bias", ".bq", ".bk", ".bv")):
            p.zero_()


def init_attention(a: nn.Module, cfg: ModelConfig, dense) -> None:
    """An attention's projections dense, its `wo` scaled by 1/sqrt(2 L)."""
    for name in ("wq", "wk", "wv", "w_dkv", "w_uk", "w_uv"):
        if hasattr(a, name):
            dense(getattr(a, name))
    dense(a.wo, scale=1.0 / math.sqrt(2 * cfg.n_layers))


def init_mlp(mlp: nn.Module, cfg: ModelConfig, dense) -> None:
    dense(mlp.wi)
    dense(mlp.wo_mlp)
    if cfg.mlp_gated:
        dense(mlp.wg)


def _init_attn_block(blk: Block, cfg: ModelConfig, dense) -> None:
    """After `init_norms_and_biases`."""
    init_attention(blk.attn, cfg, dense)
    if hasattr(blk, "moe"):
        moe = blk.moe
        dense(moe.router)
        for w in (moe.we_in, moe.we_gate, moe.we_out):
            for e in range(w.shape[0]):          # each expert's own fan-in
                dense(w[e])
        if hasattr(moe, "shared"):
            for w in (moe.shared.wi, moe.shared.wg, moe.shared.wo_mlp):
                dense(w)
        return
    init_mlp(blk.mlp, cfg, dense)


def _init_mamba_block(blk: MambaBlock, cfg: ModelConfig, dense, gen: torch.Generator) -> None:
    """After the suffix loop, which zeroes every name ending in "bias",
    `dt_bias` included."""
    m = blk.mixer
    for w in (m.wz, m.wx, m.wbc, m.wdt):
        dense(w)
    dense(m.w_out, scale=1.0 / math.sqrt(2 * cfg.n_layers))
    for w, bias in ((m.conv_x_w, m.conv_x_b), (m.conv_bc_w, m.conv_bc_b)):
        w.normal_(0.0, 1.0, generator=gen).div_(math.sqrt(cfg.ssm.d_conv))
        bias.zero_()
    n_heads = m.a_log.shape[0]
    m.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, n_heads, dtype=torch.float32)))
    m.d_skip.fill_(1.0)
    m.dt_bias.fill_(math.log(math.expm1(0.01)))
    m.gate_norm_scale.fill_(1.0)


def _init_rwkv_block(blk: RWKVBlock, cfg: ModelConfig, dense, gen: torch.Generator) -> None:
    tm, cm = blk.tm, blk.cm
    for mix in (tm.mix_r, tm.mix_k, tm.mix_v, tm.mix_w, tm.mix_g, cm.mix_k, cm.mix_r):
        mix.fill_(0.5)
    for w in (tm.wr, tm.wk, tm.wv, tm.wg, tm.decay_a, cm.wk_c, cm.wv_c, cm.wr_c):
        dense(w)
    dense(tm.wo, scale=1.0 / math.sqrt(2 * cfg.n_layers))
    dense(tm.decay_b, scale=0.1)
    tm.w0.fill_(-2.0)
    tm.bonus_u.normal_(0.0, 1.0, generator=gen).mul_(0.1)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

Params = Mapping[str, torch.Tensor]


def _groups(model_or_params: Union[nn.Module, Params]) -> dict[str, dict[str, torch.Tensor]]:
    """Parameters grouped by owning module: "blocks.3.attn" -> {"wq": ...}."""
    named = (dict(model_or_params.named_parameters())
             if isinstance(model_or_params, nn.Module) else model_or_params)
    out: dict[str, dict[str, torch.Tensor]] = {}
    for name, t in named.items():
        owner, _, leaf = name.rpartition(".")
        out.setdefault(owner, {})[leaf] = t
    return out


_BLOCK_PARTS = {"ssm": ("ln1", "ln2", "tm", "cm"), "hybrid": ("ln", "mixer"),
                "moe": ("ln1", "ln2", "attn", "moe")}


def _block(groups: dict, i: int, cfg: ModelConfig, prefix: str = "blocks"
           ) -> dict[str, dict[str, torch.Tensor]]:
    """Block i's parameters by part; a moe block's "moe" part holds its
    shared experts under "shared". `prefix` "dense_blocks" names a moe
    model's leading dense layers. The "blocks" ones go through
    `partitioning.stream_cast` (their >=2-D fp32 weights in the compute
    dtype with `weight_stream_bf16`, before any gather), as the reference
    casts its params["blocks"]."""
    parts = (_BLOCK_PARTS.get(cfg.family, ("ln1", "ln2", "attn", "mlp"))
             if prefix == "blocks" else ("ln1", "ln2", "attn", "mlp"))
    bp = {part: groups.get(f"{prefix}.{i}.{part}", {}) for part in parts}
    shared = groups.get(f"{prefix}.{i}.moe.shared")
    if shared is not None:
        bp["moe"] = {**bp["moe"], "shared": shared}
    return partitioning.stream_cast(bp, cfg) if prefix == "blocks" else bp


def _gathered_shared(groups: dict, cfg: ModelConfig) -> dict[str, dict[str, torch.Tensor]]:
    """zamba2's shared block's parameters, gathered for compute."""
    return partitioning.gather_block(
        {part: groups.get(f"shared.{part}", {}) for part in ("ln1", "ln2", "attn", "mlp")}, cfg)


def _gathered(groups: dict, i: int, cfg: ModelConfig) -> dict[str, dict[str, torch.Tensor]]:
    """Block i's parameters gathered for compute (serving: no autograd)."""
    return partitioning.gather_block(_block(groups, i, cfg), cfg)


def _lora(groups: dict, g: int, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The shared block's LoRA of invocation g."""
    return {name: t[g] for name, t in
            partitioning.gather_part("lora", groups["lora"], cfg).items()}


def attn_block_apply(bp: dict, x: torch.Tensor, cfg: ModelConfig, *,
                     positions: torch.Tensor, cache: Optional[dict] = None
                     ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """One block; `bp` maps "ln1"/"ln2"/"attn" and "mlp" or "moe" to their
    parameters. Returns (x, the MoE aux loss (0 without MoE), the cache)."""
    attend = MLA.mla_apply if cfg.mla is not None else L.attention_apply
    h, new_cache = attend(bp["attn"], L.norm_apply(bp["ln1"], x, cfg), cfg,
                          positions=positions, cache=cache)
    x = x + h
    h2in = L.norm_apply(bp["ln2"], x, cfg)
    if "moe" in bp:
        h2, aux = MOE.moe_apply(bp["moe"], h2in, cfg)
    else:
        h2 = L.mlp_apply(bp["mlp"], h2in, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h2, aux, new_cache


def rwkv_block_apply(bp: dict, x: torch.Tensor, cfg: ModelConfig, *,
                     cache: Optional[dict] = None) -> tuple[torch.Tensor, dict]:
    """One rwkv6 block; `bp` maps "ln1"/"ln2"/"tm"/"cm" to their parameters.
    cache: {"tm_shift", "wkv", "cm_shift"} of this layer, or None (zero
    states). Returns (x, the new cache)."""
    tm_cache = None if cache is None else {"shift": cache["tm_shift"], "wkv": cache["wkv"]}
    h, tm_new = RWKV.timemix_apply(bp["tm"], L.norm_apply(bp["ln1"], x, cfg), cfg,
                                   cache=tm_cache)
    x = x + h
    cm_cache = None if cache is None else {"shift": cache["cm_shift"]}
    h2, cm_new = RWKV.channelmix_apply(bp["cm"], L.norm_apply(bp["ln2"], x, cfg), cfg,
                                       cache=cm_cache)
    return x + h2, {"tm_shift": tm_new["shift"], "wkv": tm_new["wkv"],
                    "cm_shift": cm_new["shift"]}


def mamba_block_apply(bp: dict, x: torch.Tensor, cfg: ModelConfig, *,
                      cache: Optional[dict] = None) -> tuple[torch.Tensor, dict]:
    """One zamba2 mamba block; `bp` maps "ln"/"mixer" to their parameters.
    cache: {"conv_x", "conv_bc", "ssm"} of this layer, or None. Returns (x,
    the new cache)."""
    h, new_cache = SSM.mamba2_apply(bp["mixer"], L.norm_apply(bp["ln"], x, cfg), cfg,
                                    cache=cache)
    return x + h, new_cache


def shared_block_apply(shared: dict, lora: dict, x: torch.Tensor, cfg: ModelConfig, *,
                       positions: torch.Tensor, cache: Optional[dict] = None
                       ) -> tuple[torch.Tensor, dict]:
    """zamba2's shared attention block with the LoRA of one invocation on
    its attention and MLP branches (the reference's `shared_block_apply`)."""
    dt = L.cdtype(cfg)
    xn = L.norm_apply(shared["ln1"], x, cfg)
    h, new_cache = L.attention_apply(shared["attn"], xn, cfg, positions=positions, cache=cache)
    h = h + (xn @ lora["attn_a"].to(dt)) @ lora["attn_b"].to(dt)
    x = x + h
    x2n = L.norm_apply(shared["ln2"], x, cfg)
    h2 = L.mlp_apply(shared["mlp"], x2n, cfg)
    h2 = h2 + (x2n @ lora["mlp_a"].to(dt)) @ lora["mlp_b"].to(dt)
    return x + h2, new_cache


def _segment(g: int, cfg: ModelConfig) -> range:
    """The mamba layers after the shared block's invocation g."""
    period = cfg.hybrid.period
    return range(g * period, min((g + 1) * period, cfg.n_layers))


def _save_projections(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat="dots": keep the outputs of the
    matrix products without batch dims, recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _in_contexts(dp, layout, fn, *args):
    with distributed.dp_context(dp), partitioning.layout_context(layout):
        return fn(*args)


def remat_call(fn, cfg: ModelConfig, bp: dict, *args):
    """fn(bp gathered, *args), checkpointed per `cfg.remat` when autograd
    records (the reference's `_remat`); `bp` is a block's parameters,
    gathered inside the checkpointed function (`partitioning.gather_block`,
    the identity meshless), so a recompute gathers them again."""
    def body(bp_, *args_):
        return fn(partitioning.gather_block(bp_, cfg), *args_)

    if cfg.remat == "none" or not torch.is_grad_enabled():
        return body(bp, *args)
    dp, layout = distributed.current_dp(), partitioning.current_layout()
    run = body
    if dp is not None or layout is not None:
        # the recompute runs in backward, after the sharded step's loss
        # function has returned: it gathers and reduces in the same layout
        run = functools.partial(_in_contexts, dp, layout, body)
    if cfg.remat == "full":
        return ckpt.checkpoint(run, bp, *args, use_reentrant=False)
    if cfg.remat == "dots":
        return ckpt.checkpoint(run, bp, *args, use_reentrant=False,
                               context_fn=functools.partial(
                                   ckpt.create_selective_checkpoint_contexts,
                                   _save_projections))
    raise ValueError(f"unknown remat {cfg.remat!r}")


def _train_block(bp: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor
                 ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A block of the full-sequence forward, checkpointed per `cfg.remat`:
    (x, the MoE aux loss; None outside the attention families)."""
    def fn(bp_, x_, positions_):
        if cfg.family == "ssm":
            return rwkv_block_apply(bp_, x_, cfg)[0], None
        if cfg.family == "hybrid":
            return mamba_block_apply(bp_, x_, cfg)[0], None
        return attn_block_apply(bp_, x_, cfg, positions=positions_)[:2]

    return remat_call(fn, cfg, bp, x, positions)


def _final_logits(groups: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The logits (vocab-sharded under a tensor-parallel layout whose model
    axis divides the vocabulary)."""
    x = L.norm_apply(partitioning.gather_part("final_norm", groups.get("final_norm", {}), cfg),
                     x, cfg)
    name = "embed" if cfg.tie_embeddings else "unembed"
    head = partitioning.gather_part("embedding", {name: groups["embedding"][name]}, cfg)
    return L.logits_apply(head, x, cfg)


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------

def embed(groups: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The token embeddings, the table gathered where it is used."""
    table = partitioning.gather_part("embedding", {"embed": groups["embedding"]["embed"]}, cfg)
    return L.embed_tokens(table, tokens, cfg)


def _embed_inputs(groups: dict, batch: dict, cfg: ModelConfig,
                  blk: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """Token embeddings of positions [lo, hi) (`blk`; all of them for None);
    a vlm model's first n_image_tokens positions are overwritten with the
    projected patch embeddings, of which a block projects those it holds
    (the projector's gradient then partial, `partitioning.gather_part`)."""
    lo, hi = (0, batch["tokens"].shape[1]) if blk is None else blk
    x = embed(groups, batch["tokens"][:, lo:hi], cfg)
    if cfg.vision is not None and "patch_embeds" in batch:
        dt = L.cdtype(cfg)
        n = batch["patch_embeds"].shape[1]
        if n > batch["tokens"].shape[1]:
            raise ValueError(f"{n} image tokens do not fit a sequence of "
                             f"{batch['tokens'].shape[1]}")
        # every rank gathers the projector (and reduces its gradient), its
        # block holding image positions or none
        proj = partitioning.gather_part("", {"projector": groups[""]["projector"]}, cfg)
        patches = batch["patch_embeds"][:, lo:max(lo, min(n, hi))].to(dt) @ proj["projector"].to(dt)
        x = torch.cat([patches.to(x.dtype), x[:, patches.shape[1]:]], dim=1)
    return x


def _layers(groups: dict, cfg: ModelConfig):
    """(block parameters, the block's config, its index among the cached
    layers, dense) in execution order: a moe model's leading dense layers,
    then the blocks."""
    nd = n_dense(cfg)
    if nd:
        dcfg = dense_cfg(cfg)
        for j in range(nd):
            yield _block(groups, j, dcfg, "dense_blocks"), dcfg, j, True
    for i in range(cfg.n_layers - nd):
        yield _block(groups, i, cfg), cfg, i, False


def _block_inputs(groups: dict, batch: dict, cfg: ModelConfig, blk: Optional[tuple[int, int]]
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The embedded inputs and their positions: of this rank's sequence
    block [lo, hi) (`partitioning.sequence_block`), else of the whole
    sequence."""
    x = _embed_inputs(groups, batch, cfg, blk)
    lo = 0 if blk is None else blk[0]
    return x, torch.arange(lo, lo + x.shape[1], device=x.device)[None, :]


def forward(model: Union[Transformer, Params], batch: dict, cfg: ModelConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward of the model or of a mapping of its parameter
    names to tensors. Returns (logits, aux_loss): the MoE aux loss summed
    over the layers, 0 without MoE. Under the sequence-parallel layout the
    logits are this rank's block's (`partitioning.sp_range`)."""
    with partitioning.sequence_block(cfg, batch["tokens"].shape[1]) as blk:
        return _forward(_groups(model), batch, cfg, blk)


def _forward(groups: dict, batch: dict, cfg: ModelConfig, blk: Optional[tuple[int, int]]
             ) -> tuple[torch.Tensor, torch.Tensor]:
    x, positions = _block_inputs(groups, batch, cfg, blk)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        for g in range(_n_shared_invocations(cfg)):
            x, _ = shared_block_apply(_gathered_shared(groups, cfg), _lora(groups, g, cfg), x, cfg,
                                      positions=positions)
            for i in _segment(g, cfg):
                x, _ = _train_block(_block(groups, i, cfg), x, cfg, positions)
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x, _ = _train_block(_block(groups, i, cfg), x, cfg, positions)
    else:
        for bp, bcfg, _, _ in _layers(groups, cfg):
            x, aux = _train_block(bp, x, bcfg, positions)
            aux_total = aux_total + aux
    logits = _final_logits(groups, x, cfg)
    return logits, aux_total


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, pos: int = 0,
               device: Device = "cuda") -> dict:
    """Zero cache: {"layers": {"k", "v": (L, B, max_len, K, hd)}, "pos": int};
    for rwkv6 {"layers": {"tm_shift", "cm_shift": (L, B, 1, D), "wkv": (L, B,
    H, K, V)}, "pos": int} (no sequence axis: `max_len` is not used); for
    zamba2 {"layers": {"conv_x", "conv_bc": (L, B, d_conv - 1, C), "ssm": (L, B,
    H, P, N)}, "shared": {"k", "v": (n_inv, B, max_len, K, hd)}, "pos": int}; with
    MLA {"c_kv": (L, B, max_len, R), "k_rope": (L, B, max_len, rope)} in place
    of k/v; a moe model with leading dense layers also has "dense_layers", a
    list of one such per-layer dict each (L counts the other layers).

    The same structure as the reference's (and as `prefill` emits); `pos` is a
    Python int since the host drives the decode loop.
    """
    check_supported(cfg)
    if cfg.family in ("ssm", "hybrid"):
        layer = (RWKV.rwkv_cache_shape(cfg, batch, device) if cfg.family == "ssm"
                 else SSM.mamba2_cache_shape(cfg, batch, device))
        cache = {"layers": {name: t.expand(cfg.n_layers, *t.shape).clone()
                            for name, t in layer.items()}}
        if cfg.family == "hybrid":
            cache["shared"] = _kv_cache(cfg, _n_shared_invocations(cfg), batch, max_len, device)
        return {**cache, "pos": pos}
    nd = n_dense(cfg)
    cache = {"layers": _kv_cache(cfg, cfg.n_layers - nd, batch, max_len, device), "pos": pos}
    if nd:
        # the leading dense layers share the attention kind (MLA for
        # deepseek), so their caches mirror the other layers' structure
        cache["dense_layers"] = [{name: t[0] for name, t in
                                  _kv_cache(cfg, 1, batch, max_len, device).items()}
                                 for _ in range(nd)]
    return cache


def _kv_cache(cfg: ModelConfig, n: int, batch: int, max_len: int, device: Device) -> dict:
    cdt = L.cdtype(cfg)
    if cfg.mla is not None:
        m = cfg.mla
        return {"c_kv": torch.zeros((n, batch, max_len, m.kv_lora_rank), dtype=cdt,
                                    device=device),
                "k_rope": torch.zeros((n, batch, max_len, m.qk_rope_head_dim), dtype=cdt,
                                      device=device)}
    shape = (n, batch, max_len, partitioning.local_kv_heads(cfg), cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device)}


def _layer_cache(cache: dict, i: int, dense: bool) -> dict:
    """Layer i's cache tensors (views): of the dense layers or of the others."""
    if dense:
        return cache["dense_layers"][i]
    return {name: t[i] for name, t in cache["layers"].items()}


def prefill(model: Transformer, batch: dict, cfg: ModelConfig, pad_to: int = 0
            ) -> tuple[torch.Tensor, dict]:
    """Run the prompt; return (last-position logits, cache) with cache length
    max(S, pad_to) and pos = S (under `partitioning.cache_sequence`, this
    rank's block of that length)."""
    with partitioning.sequence_block(cfg, batch["tokens"].shape[1]) as blk:
        return _prefill(_groups(model), batch, cfg, pad_to, blk)


def _last_block(t: torch.Tensor, blk: Optional[tuple[int, int]]) -> torch.Tensor:
    """`t` as the model group's last rank has it (its block holds the
    sequence's end); `t` itself where the sequence is whole."""
    if blk is None:
        return t
    lay = partitioning.current_layout()
    return distributed.broadcast_from(t, lay.model_group, lay.m - 1)


def _write_kv(t: torch.Tensor, kv: torch.Tensor) -> None:
    """Prefill's k or v (B, S, ...) of the whole prompt into cache tensor
    t (B, n, ...): positions [0, S) where every rank holds the cache whole,
    else those of this rank's block (`partitioning.cache_block`)."""
    cblk = partitioning.cache_block(t.shape[1])
    L.write_positions(t, kv, 0, 0 if cblk is None else cblk[0])


def _whole_seq(t: torch.Tensor, blk: Optional[tuple[int, int]], cfg: ModelConfig
               ) -> torch.Tensor:
    """A prefill's cache entry of the whole prompt: `t` itself (attention
    returns k/v gathered whole), or under a sequence block MLA's latents of
    the block, gathered over the model group."""
    if blk is None or cfg.mla is None:
        return t
    return distributed.gather_seq(t, partitioning.current_layout())


def _prefill_states(groups: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                    seq_len: int, length: int, blk: Optional[tuple[int, int]]
                    ) -> tuple[torch.Tensor, dict]:
    """The prefill of rwkv6 and zamba2: each layer's states (the token
    shifts and the wkv state, or the conv tails and the SSM state, as the
    layout computes them: a "tp" rank's heads and columns) from the block
    that holds the prompt's end, zamba2's shared k/v into a cache of
    `length` positions."""
    states, shared = [], None
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x, c = rwkv_block_apply(_gathered(groups, i, cfg), x, cfg)
            states.append(c)
    else:
        shared = _kv_cache(cfg, _n_shared_invocations(cfg), x.shape[0],
                           length // partitioning.cache_ways(), x.device)
        for g in range(_n_shared_invocations(cfg)):
            x, kv = shared_block_apply(_gathered_shared(groups, cfg), _lora(groups, g, cfg), x,
                                       cfg, positions=positions)
            _write_kv(shared["k"][g], kv["k"])
            _write_kv(shared["v"][g], kv["v"])
            for i in _segment(g, cfg):
                x, c = mamba_block_apply(_gathered(groups, i, cfg), x, cfg)
                states.append(c)
    cache = {"layers": {name: _last_block(torch.stack([c[name] for c in states]), blk)
                        for name in states[0]}}
    if shared is not None:
        cache["shared"] = shared
    cache["pos"] = seq_len
    return _final_logits(groups, _last_block(x[:, -1:], blk), cfg), cache


def _prefill(groups: dict, batch: dict, cfg: ModelConfig, pad_to: int,
             blk: Optional[tuple[int, int]]) -> tuple[torch.Tensor, dict]:
    S = batch["tokens"].shape[1]
    x, positions = _block_inputs(groups, batch, cfg, blk)
    if cfg.family in ("ssm", "hybrid"):
        return _prefill_states(groups, x, positions, cfg, S, max(S, pad_to), blk)
    B = x.shape[0]
    length = max(S, pad_to)
    cache = init_cache(cfg, B, length // partitioning.cache_ways(), pos=S, device=x.device)
    for bp, bcfg, i, dense in _layers(groups, cfg):
        x, _, kv = attn_block_apply(partitioning.gather_block(bp, bcfg), x, bcfg,
                                    positions=positions)
        for name, t in _layer_cache(cache, i, dense).items():
            _write_kv(t, _whole_seq(kv[name], blk, cfg))
    logits = _final_logits(groups, _last_block(x[:, -1:], blk), cfg)
    return logits, cache


def decode(model: Transformer, cache: dict, batch: dict, cfg: ModelConfig
           ) -> tuple[torch.Tensor, dict]:
    """One decode step: batch["tokens"] (B, S_new) -> (logits (B,S_new,V), cache).

    The cache's k/v (rwkv6 and zamba2: its states) are updated in place; the
    returned cache carries the advanced `pos`.
    """
    groups = _groups(model)
    x = embed(groups, batch["tokens"], cfg)
    S_new = x.shape[1]
    pos = cache["pos"]
    if cfg.family == "ssm":
        layers = cache["layers"]
        for i in range(cfg.n_layers):
            x, new = rwkv_block_apply(_gathered(groups, i, cfg), x, cfg,
                                      cache={name: t[i] for name, t in layers.items()})
            for name, t in layers.items():
                t[i].copy_(new[name])
        return _final_logits(groups, x, cfg), {"layers": layers, "pos": pos + S_new}
    positions = pos + torch.arange(S_new, device=x.device)[None, :]
    if cfg.family == "hybrid":
        layers, shared = cache["layers"], cache["shared"]
        for g in range(_n_shared_invocations(cfg)):
            x, _ = shared_block_apply(_gathered_shared(groups, cfg), _lora(groups, g, cfg), x, cfg,
                                      positions=positions,
                                      cache={"k": shared["k"][g], "v": shared["v"][g],
                                             "pos": pos})
            for i in _segment(g, cfg):
                x, new = mamba_block_apply(_gathered(groups, i, cfg), x, cfg,
                                           cache={name: t[i] for name, t in layers.items()})
                for name, t in layers.items():
                    t[i].copy_(new[name])
        return _final_logits(groups, x, cfg), {**cache, "pos": pos + S_new}
    for bp, bcfg, i, dense in _layers(groups, cfg):
        x, _, _ = attn_block_apply(partitioning.gather_block(bp, bcfg), x, bcfg,
                                   positions=positions,
                                   cache={**_layer_cache(cache, i, dense), "pos": pos})
    logits = _final_logits(groups, x, cfg)
    return logits, {**cache, "pos": pos + S_new}
