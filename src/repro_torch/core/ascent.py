"""Ascent-gradient channel: batch slicing and the exchange's compressor
(counterpart of `repro.core.ascent`).

Ported: how the b'-sized ascent batch is derived from (or supplied with) the
step batch, the system-aware b' of paper §3.3, and the lossless
`Compressor(kind="none")`. The int8 / top-k compressors and the staleness
ledger of the heterogeneous executor come with Form B (ROADMAP.md queue 1)
and raise here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

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
    """Residual error-feedback memory (empty for the lossless exchange)."""
    error: Tree


@dataclasses.dataclass(frozen=True)
class Compressor:
    """The ascent exchange's compressor. Only kind="none" is ported."""
    kind: str = "none"
    topk_fraction: float = 0.01

    def __post_init__(self):
        if self.kind != "none":
            raise NotImplementedError(
                f"Compressor(kind={self.kind!r}) is not ported yet: the lossy ascent "
                f"exchange comes with Form B, ROADMAP.md queue 1")

    def init(self, params) -> CompressionState:
        return CompressionState(error=())

    def compress(self, grad, state: CompressionState):
        return grad, state
