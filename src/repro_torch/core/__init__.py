"""repro_torch.core: AsyncSAM (Form A, and Form B's split ascent and descent
functions) and the SGD / SAM baselines (counterpart of `repro.core`).

The other methods of the reference's registry (gsam, looksam, esam, aesam,
mesa) are not ported yet: `make_method` raises for them, naming their
ROADMAP item.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.api import (  # noqa: F401
    GUARD,
    LossFn,
    Method,
    MethodConfig,
    TrainState,
    init_train_state,
    step_rng,
)
from repro_torch.core.ascent import (  # noqa: F401
    Compressor,
    StalenessLedger,
    slice_ascent_batch,
    split_batch,
    system_aware_ascent_fraction,
)
from repro_torch.core.async_sam import (  # noqa: F401
    AsyncSamState,
    make_ascent_fn,
    make_async_sam,
    make_descent_fn,
)
from repro_torch.core.perturb import perturb, perturb_masked  # noqa: F401
from repro_torch.core.sam import make_sam, make_sgd  # noqa: F401

_REGISTRY = {
    "sgd": make_sgd,
    "sam": make_sam,
    "async_sam": make_async_sam,
}
_NOT_PORTED = ("gsam", "looksam", "esam", "aesam", "mesa")


def available_methods() -> list[str]:
    return sorted(_REGISTRY)


def make_method(cfg: MethodConfig) -> Method:
    """Instantiate a training method from its config (name-dispatched)."""
    if cfg.name in _NOT_PORTED:
        raise NotImplementedError(f"method {cfg.name!r} is not ported yet: method "
                                  f"variants, ROADMAP.md queue 1")
    try:
        factory = _REGISTRY[cfg.name]
    except KeyError:
        raise ValueError(f"unknown method {cfg.name!r}; available: "
                         f"{available_methods()}") from None
    if cfg.guard_update:
        raise NotImplementedError(GUARD)
    return dataclasses.replace(factory(cfg), cfg=cfg)
