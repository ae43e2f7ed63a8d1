"""Model bundles: a uniform (init / loss / forward / prefill / decode /
init_cache) surface (counterpart of `repro.models.registry`).

The port's bundle takes the model (an `nn.Module`, or for `forward` and
`loss_fn` a mapping of its parameter names to tensors) where the reference
takes a parameter pytree, and `init(seed, device)` where it takes a PRNG key.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init: Callable[..., transformer.Transformer]
    forward: Callable[[transformer.Transformer, dict], tuple[torch.Tensor, torch.Tensor]]
    prefill: Callable[..., tuple[torch.Tensor, dict]]
    decode: Callable[[transformer.Transformer, dict, dict], tuple[torch.Tensor, dict]]
    init_cache: Callable[..., dict]

    def loss_fn(self, model_or_params, batch: dict,
                gen: Optional[torch.Generator] = None) -> tuple[torch.Tensor, dict]:
        """Next-token cross entropy + MoE aux loss (the reference's protocol:
        `repro_torch.core`'s loss callback). Takes the model or a mapping of
        its parameter names to tensors; draws nothing from `gen`."""
        logits, aux_loss = self.forward(model_or_params, batch)
        ce = cross_entropy(logits, batch["labels"])
        return ce + aux_loss, {"ce": ce, "moe_aux": aux_loss, "logits": logits}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE in fp32 over positions with labels >= 0."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, labels.long().clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - picked) * mask).sum() / mask.sum().clamp_min(1.0)


def build_model(cfg: ModelConfig) -> ModelBundle:
    transformer.check_supported(cfg)
    return ModelBundle(
        cfg=cfg,
        init=lambda seed=0, device="cuda": transformer.init_params(cfg, seed, device),
        forward=lambda m, b: transformer.forward(m, b, cfg),
        prefill=lambda m, b, pad_to=0: transformer.prefill(m, b, cfg, pad_to=pad_to),
        decode=lambda m, c, b: transformer.decode(m, c, b, cfg),
        init_cache=lambda batch, max_len, pos=0, device="cuda": transformer.init_cache(
            cfg, batch, max_len, pos, device),
    )


def synth_batch(cfg: ModelConfig, b: int, s: int, seed: int = 0,
                device: transformer.Device = "cuda") -> dict:
    """Random token batch drawn with numpy from `seed`; labels are the tokens
    shifted left, with -1 (masked) at the last position."""
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s),
                                                  dtype=np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": torch.from_numpy(tokens).to(device),
            "labels": torch.from_numpy(labels).to(device)}


def analytic_param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact count from the model built on the meta device (no memory);
    `active_only` subtracts inactive experts (no MoE family is ported yet)."""
    del active_only
    model = transformer.init_params(cfg, device="meta")
    return sum(p.numel() for p in model.parameters())

