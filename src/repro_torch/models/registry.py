"""Model bundles: a uniform (init / loss / forward / prefill / decode /
init_cache) surface (counterpart of `repro.models.registry`).

The port's bundle takes the model (an `nn.Module`, or for `forward` and
`loss_fn` a mapping of its parameter names to tensors) where the reference
takes a parameter pytree, and `init(seed, device)` where it takes a PRNG key.
The audio family (whisper) is `encdec`'s, every other family `transformer`'s.
Under a tensor-parallel layout the logits come vocab-sharded and the loss
is `vocab_parallel_cross_entropy`, which reduces them over "model"; under
the sequence-parallel layout they are this rank's sequence block's and the
loss is `sequence_parallel_cross_entropy`, the global masked mean.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.models import encdec, partitioning, transformer
from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.utils import distributed


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init: Callable[..., nn.Module]
    forward: Callable[[nn.Module, dict], tuple[torch.Tensor, torch.Tensor]]
    prefill: Callable[..., tuple[torch.Tensor, dict]]
    decode: Callable[[nn.Module, dict, dict], tuple[torch.Tensor, dict]]
    init_cache: Callable[..., dict]

    def loss_fn(self, model_or_params, batch: dict,
                gen: Optional[torch.Generator] = None) -> tuple[torch.Tensor, dict]:
        """Next-token cross entropy + MoE aux loss (the reference's protocol:
        `repro_torch.core`'s loss callback). Takes the model or a mapping of
        its parameter names to tensors; draws nothing from `gen`."""
        logits, aux_loss = self.forward(model_or_params, batch)
        labels = batch["labels"]
        blk = (encdec.seq_blocks(self.cfg, labels.shape[1], batch["enc_frames"].shape[1])[0]
               if self.cfg.family == "audio" else partitioning.sp_range(self.cfg, labels.shape[1]))
        if blk is not None:     # this rank's block of the sequence
            ce = sequence_parallel_cross_entropy(logits, labels[:, blk[0]:blk[1]], self.cfg)
        elif logits.shape[-1] == self.cfg.vocab_size:
            ce = cross_entropy(logits, batch["labels"])
        else:   # this rank's vocabulary shard
            ce = vocab_parallel_cross_entropy(logits, batch["labels"], self.cfg)
        return ce + aux_loss, {"ce": ce, "moe_aux": aux_loss, "logits": logits}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE in fp32 over positions with labels >= 0."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, labels.long().clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - picked) * mask).sum() / mask.sum().clamp_min(1.0)


class _VocabParallelCE(torch.autograd.Function):
    """Per-position lse - logit[label] of logits split on the vocabulary
    over the model group (this rank's entries [lo, lo + V/m)), in fp32: the
    max and the sum of exponentials all-reduced over the group, the label's
    logit taken from the rank that holds it. The gradient is softmax -
    onehot on the local entries, as autograd of the whole one."""

    @staticmethod
    def forward(ctx, logits, labels, lo, group):
        lf = logits.float()
        mx = lf.amax(dim=-1)
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
        ex = torch.exp(lf - mx[..., None])
        se = ex.sum(dim=-1)
        dist.all_reduce(se, group=group)
        idx = labels.long().clamp_min(0) - lo
        mine = (idx >= 0) & (idx < lf.shape[-1])
        picked = torch.gather(lf, -1, idx.clamp(0, lf.shape[-1] - 1)[..., None])[..., 0]
        picked = picked * mine
        dist.all_reduce(picked, group=group)
        ctx.save_for_backward(ex.div_(se[..., None]), idx, mine)
        ctx.dtype = logits.dtype
        return torch.log(se) + mx - picked

    @staticmethod
    def backward(ctx, g):
        soft, idx, mine = ctx.saved_tensors
        grad = soft * g[..., None]
        onehot = torch.zeros_like(grad).scatter_(
            -1, idx.clamp(0, grad.shape[-1] - 1)[..., None], (g * mine)[..., None])
        return (grad - onehot).to(ctx.dtype), None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 cfg: ModelConfig) -> torch.Tensor:
    """`cross_entropy` of logits sharded on the vocabulary over the current
    tensor-parallel layout's model group (`partitioning.tp_layout`): the
    same value on every rank of the group."""
    lay = partitioning.tp_layout(cfg)
    lo, _ = lay.shard_range(cfg.vocab_size)
    per = _VocabParallelCE.apply(logits, labels, lo, lay.model_group)
    mask = (labels >= 0).float()
    return (per * mask).sum() / mask.sum().clamp_min(1.0)


def sequence_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                    cfg: ModelConfig) -> torch.Tensor:
    """`cross_entropy` of the whole sequence from this rank's block of
    logits and labels under the sequence-parallel layout: the sum over the
    block's labelled positions and their count, each summed over the model
    group, divide. Each rank's term is its share, its sum over the global
    count, and the forward adds the shares (`distributed.group_sum`), so the
    value is the global mean on every rank and the shares' gradients, summed
    over the group where the weights are gathered, are the mean's. (The
    blocks' counts differ, the last holding the -1 label: a mean of the
    ranks' means is not the mean.)"""
    lay = partitioning.sp_layout(cfg)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, labels.long().clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    count = mask.sum()
    dist.all_reduce(count, group=lay.model_group)
    share = ((lse - picked) * mask).sum() / count.clamp_min(1.0)
    return distributed.group_sum(share, lay.model_group)


def build_model(cfg: ModelConfig) -> ModelBundle:
    mod = encdec if cfg.family == "audio" else transformer
    if mod is transformer:
        transformer.check_supported(cfg)
    return ModelBundle(
        cfg=cfg,
        init=lambda seed=0, device="cuda": mod.init_params(cfg, seed, device),
        forward=lambda m, b: mod.forward(m, b, cfg),
        prefill=lambda m, b, pad_to=0: mod.prefill(m, b, cfg, pad_to=pad_to),
        decode=lambda m, c, b: mod.decode(m, c, b, cfg),
        init_cache=lambda batch, max_len, pos=0, device="cuda": mod.init_cache(
            cfg, batch, max_len, pos, device),
    )


def whisper_enc_len(cfg: ModelConfig, dec_len: int) -> int:
    """Encoder frames for a decoder length: min(dec_len * enc_len_ratio,
    dec_len), as the reference's."""
    return min(int(dec_len * cfg.encdec.enc_len_ratio), dec_len)


def stub_shapes(cfg: ModelConfig, b: int, s: int) -> dict[str, tuple[int, ...]]:
    """The modality-stub inputs of a batch of b x s tokens: the vlm family's
    precomputed patch embeddings and the audio family's frame embeddings."""
    shapes = {}
    if cfg.vision is not None:
        shapes["patch_embeds"] = (b, cfg.vision.n_image_tokens, cfg.vision.clip_dim)
    if cfg.family == "audio":
        shapes["enc_frames"] = (b, whisper_enc_len(cfg, s), cfg.d_model)
    return shapes


# ---------------------------------------------------------------------------
# Input specs: tensors with no data for the dry run (the reference's
# ShapeDtypeStructs), made under the caller's FakeTensorMode
# (`utils.abstract.fake_mode()`)
# ---------------------------------------------------------------------------

def batch_spec(cfg: ModelConfig, shape: ShapeSpec, ascent_fraction: float = 0.0,
               device: transformer.Device = "cuda") -> dict:
    """A train or prefill batch of the cell's shape: tokens and labels (B, S)
    int32, the stub inputs in the compute dtype and, for a train cell with
    `ascent_fraction`, the ascent slice of max(1, round(B * fraction)) rows."""
    b, s = shape.global_batch, shape.seq_len
    spec = _one_batch_spec(cfg, b, s, device)
    if shape.kind == "train" and ascent_fraction > 0:
        spec["ascent"] = _one_batch_spec(cfg, max(1, int(round(b * ascent_fraction))), s,
                                         device)
    return spec


def _one_batch_spec(cfg: ModelConfig, b: int, s: int, device) -> dict:
    spec = {"tokens": torch.empty((b, s), dtype=torch.int32, device=device),
            "labels": torch.empty((b, s), dtype=torch.int32, device=device)}
    for name, shape in stub_shapes(cfg, b, s).items():
        spec[name] = torch.empty(shape, dtype=getattr(torch, cfg.compute_dtype), device=device)
    return spec


def decode_batch_spec(cfg: ModelConfig, shape: ShapeSpec,
                      device: transformer.Device = "cuda") -> dict:
    """One new token a row: tokens (B, 1) int32."""
    return {"tokens": torch.empty((shape.global_batch, 1), dtype=torch.int32, device=device)}


def cache_spec(cfg: ModelConfig, shape: ShapeSpec, device: transformer.Device = "cuda") -> dict:
    """The decode cache of the cell's batch and length at pos = seq_len - 1
    (one slot left)."""
    return build_model(cfg).init_cache(shape.global_batch, shape.seq_len,
                                       pos=shape.seq_len - 1, device=device)


def synth_batch(cfg: ModelConfig, b: int, s: int, seed: int = 0,
                device: transformer.Device = "cuda") -> dict:
    """Random batch drawn with numpy from `seed`: tokens, labels (the tokens
    shifted left, -1 (masked) at the last position) and, as the reference's
    `_synth_one` adds them, the stub inputs (standard normal, in the compute
    dtype)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(b, s), dtype=np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": torch.from_numpy(tokens).to(device),
             "labels": torch.from_numpy(labels).to(device)}
    for name, shape in stub_shapes(cfg, b, s).items():
        batch[name] = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            device=device, dtype=getattr(torch, cfg.compute_dtype))
    return batch


def analytic_param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact count from the model built on the meta device (no memory);
    `active_only` subtracts the inactive experts of every MoE layer."""
    model = build_model(cfg).init(device="meta")
    total = sum(p.numel() for p in model.parameters())
    if active_only and cfg.moe is not None:
        e, k = cfg.moe.n_experts, cfg.moe.top_k
        expert_params = 3 * cfg.d_model * cfg.moe.expert_d_ff
        n_moe_layers = cfg.n_layers - cfg.moe.first_dense_layers
        total -= n_moe_layers * (e - k) * expert_params
    return int(total)

