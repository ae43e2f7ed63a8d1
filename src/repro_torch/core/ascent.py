"""Ascent-gradient channel: batch slicing and the exchange's compressor
(counterpart of `repro.core.ascent`).

How the b'-sized ascent batch is derived from (or supplied with) the step
batch, the system-aware b' of paper §3.3, lossy compression of the ascent
exchange (int8 / top-k with error feedback: the perturbation *direction*
tolerates quantization noise by the same sigma^2/b' argument that tolerates
b' < b), and the staleness ledger of the heterogeneous executor. On a mesh
of ranks (`engine.fused`) the ascent gradient, like the descent's, is the
mean over the data-parallel group (the reference's `global` semantics,
which GSPMD gives it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.utils import buckets, trees

Tree = Any


def slice_ascent_batch(batch: dict, fraction: float) -> dict:
    """Take the leading `fraction` of the batch axis as the ascent batch
    (rounded, at least one sample), as the reference does."""
    def f(x):
        b = x.shape[0]
        bp = max(1, int(round(b * fraction)))
        return x[:bp]

    return {k: f(v) for k, v in batch.items()}


def split_batch(batch: dict) -> tuple[dict, Optional[dict]]:
    """Split a pipeline batch into (descent, ascent-or-None)."""
    if isinstance(batch, dict) and "ascent" in batch:
        descent = {k: v for k, v in batch.items() if k != "ascent"}
        return descent, batch["ascent"]
    return batch, None


def system_aware_ascent_fraction(t_fast: float, t_slow: float,
                                 floor: float = 0.05, cap: float = 1.0) -> float:
    """Paper §3.3:  b' = (T_f / T_s) * b  from measured per-sample grad times,
    clipped to [floor, cap] so a pathological measurement never stalls
    training."""
    if t_slow <= 0 or t_fast <= 0:
        return cap
    return float(min(cap, max(floor, t_fast / t_slow)))


class CompressionState(NamedTuple):
    """Residual error-feedback memory, one leaf per parameter leaf."""
    error: Tree


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Lossy tree compressor with error feedback.

    kind: "none" | "int8" | "topk"
    topk_fraction: fraction of elements kept per leaf for kind="topk".
    """
    kind: str = "none"
    topk_fraction: float = 0.01

    def init(self, params: Tree) -> CompressionState:
        if self.kind == "none":
            return CompressionState(error=())
        return CompressionState(error=trees.tree_zeros_like(params, torch.float32))

    def compress(self, grad: Tree, state: CompressionState) -> tuple[Tree, CompressionState]:
        """Return (decompressed lossy gradient, new residual state).

        The returned tree is the value the *receiver* reconstructs; callers
        use it in place of the exact gradient. The residual g + e - Q(g + e)
        is carried so the quantization error is unbiased over time (error
        feedback)."""
        if self.kind == "none":
            return grad, state
        corrected = trees.tree_map(lambda g, e: g.float() + e, grad, state.error)
        if self.kind == "int8":
            quant = trees.tree_map(_int8_roundtrip, corrected)
        elif self.kind == "topk":
            quant = trees.tree_map(lambda x: _topk_roundtrip(x, self.topk_fraction), corrected)
        else:
            raise ValueError(f"unknown compressor kind {self.kind!r}")
        new_err = trees.tree_map(torch.subtract, corrected, quant)
        quant = trees.tree_map(lambda q, g: q.to(g.dtype), quant, grad)
        return quant, CompressionState(error=new_err)

    def wire_bytes(self, grad: Tree) -> int:
        """Exact *payload* bytes for one exchange: per leaf, what
        `service.protocol.encode_grad` serializes (frame overhead is
        `service.protocol.grad_frame_bytes`'s)."""
        leaves, _ = buckets.host_flatten(grad)
        n = sum(math.prod(x.shape) for x in leaves)
        if self.kind == "none":
            return 4 * n
        if self.kind == "int8":
            return n + 8 * len(leaves)             # payload + per-leaf scale
        if self.kind == "topk":
            # per-leaf k; 8 bytes per kept entry: (u32 index, fp32 value)
            return sum(8 * max(1, int(math.prod(x.shape) * self.topk_fraction))
                       for x in leaves)
        raise ValueError(self.kind)


def _int8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Symmetric per-leaf int8 quantize -> dequantize."""
    amax = torch.amax(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q.float() * scale


def _topk_roundtrip(x: torch.Tensor, fraction: float) -> torch.Tensor:
    """Keep the top-|fraction| magnitude entries, zero the rest."""
    flat = x.reshape(-1)
    k = max(1, int(flat.shape[0] * fraction))
    _, idx = torch.topk(torch.abs(flat), k)
    out = torch.zeros_like(flat)
    out[idx] = flat[idx]
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# Staleness ledger (host-side bookkeeping for the heterogeneous executor)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StalenessLedger:
    """Tracks the age (tau) of the ascent gradient currently in use.

    The paper fixes tau = 1; the executor lets tau grow up to
    `max_staleness` under stragglers, after which the step degrades to SGD
    (no perturbation)."""
    max_staleness: int = 4
    tau: int = 0            # age of the held ascent gradient, in steps
    refreshes: int = 0      # how many fresh ascent grads were consumed
    stale_reuses: int = 0   # steps that reused an old gradient (tau grew)
    sgd_fallbacks: int = 0  # steps that ran without perturbation

    def on_fresh(self) -> None:
        self.tau = 1
        self.refreshes += 1

    def on_reuse(self) -> bool:
        """Advance age; return True if the gradient is still usable."""
        self.tau += 1
        if self.tau > self.max_staleness:
            self.sgd_fallbacks += 1
            return False
        self.stale_reuses += 1
        return True

    def summary(self) -> dict:
        return dict(tau=self.tau, refreshes=self.refreshes,
                    stale_reuses=self.stale_reuses, sgd_fallbacks=self.sgd_fallbacks)
