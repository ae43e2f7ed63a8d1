"""Architecture config registry (counterpart of `repro.configs`).

Lists all ten of the reference's archs, in its order: the dense decoders, the
MoE (mixtral-8x7b, deepseek-v2-lite-16b with MLA), hybrid (zamba2), ssm
(rwkv6), vision-stub (phi-3-vision) and encoder-decoder (whisper-tiny)
families.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

# assigned architecture ids -> module names
_ARCH_MODULES = {
    "mixtral-8x7b": "mixtral_8x7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "zamba2-1.2b": "zamba2_1_2b",
    "gemma-2b": "gemma_2b",
    "qwen2.5-32b": "qwen2_5_32b",
    "qwen3-8b": "qwen3_8b",
    "olmo-1b": "olmo_1b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "rwkv6-7b": "rwkv6_7b",
    "whisper-tiny": "whisper_tiny",
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
