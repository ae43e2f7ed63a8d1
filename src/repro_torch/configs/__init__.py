"""Architecture config registry (counterpart of `repro.configs`).

Lists the archs of the families the port supports (dense, rwkv6, zamba2), in
the reference's order; the MoE, MLA, vision and audio archs join as their
families are ported.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

# supported architecture ids -> module names
_ARCH_MODULES = {
    "zamba2-1.2b": "zamba2_1_2b",
    "gemma-2b": "gemma_2b",
    "qwen2.5-32b": "qwen2_5_32b",
    "qwen3-8b": "qwen3_8b",
    "olmo-1b": "olmo_1b",
    "rwkv6-7b": "rwkv6_7b",
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
