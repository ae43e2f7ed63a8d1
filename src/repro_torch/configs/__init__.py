"""Architecture config registry (counterpart of `repro.configs`).

Lists only the archs the port supports; the others join as their model
families are ported.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

# supported architecture ids -> module names
_ARCH_MODULES = {
    "olmo-1b": "olmo_1b",
    "rwkv6-7b": "rwkv6_7b",
    "zamba2-1.2b": "zamba2_1_2b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    try:
        module_name = _ARCH_MODULES[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; available: {sorted(_ARCH_MODULES)}"
                         ) from None
    mod = importlib.import_module(f"repro_torch.configs.{module_name}")
    return mod.REDUCED if reduced else mod.CONFIG
