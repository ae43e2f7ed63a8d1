"""repro_torch.core: AsyncSAM (Form A, and Form B's split ascent and descent
functions) and the SAM family it is compared against: SGD, SAM, GSAM,
LookSAM, ESAM, AE-SAM and MESA (counterpart of `repro.core`).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.api import (  # noqa: F401
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
from repro_torch.core.perturb import perturb, perturb_masked, perturbation_scale  # noqa: F401
from repro_torch.core.sam import make_gsam, make_sam, make_sgd  # noqa: F401
from repro_torch.core.variants import (  # noqa: F401
    make_aesam,
    make_esam,
    make_looksam,
    make_mesa,
)

_REGISTRY = {
    "sgd": make_sgd,
    "sam": make_sam,
    "gsam": make_gsam,
    "async_sam": make_async_sam,
    "looksam": make_looksam,
    "esam": make_esam,
    "aesam": make_aesam,
    "mesa": make_mesa,
}


def available_methods() -> list[str]:
    return sorted(_REGISTRY)


def make_method(cfg: MethodConfig) -> Method:
    """Instantiate a training method from its config (name-dispatched)."""
    try:
        factory = _REGISTRY[cfg.name]
    except KeyError:
        raise ValueError(f"unknown method {cfg.name!r}; available: "
                         f"{available_methods()}") from None
    return dataclasses.replace(factory(cfg), cfg=cfg)
