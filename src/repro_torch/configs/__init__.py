"""Architecture registry of the port: ``get_config(arch)`` -> ModelConfig.

The reference's ten archs (``repro/configs/__init__.py``), each with its
full-size ``CONFIG`` and its ``SMOKE`` variant, field for field the same.
"""

from __future__ import annotations

from repro_torch.configs import (deepseek_67b, deepseek_moe_16b,
                                 granite_3_8b, hymba_1_5b,
                                 llama4_scout_17b_a16e, pixtral_12b,
                                 rwkv6_3b, stablelm_1_6b, starcoder2_3b,
                                 whisper_tiny)
from repro_torch.configs.base import ModelConfig

_MODULES = {
    "granite-3-8b": granite_3_8b,
    "stablelm-1.6b": stablelm_1_6b,
    "starcoder2-3b": starcoder2_3b,
    "deepseek-67b": deepseek_67b,
    "whisper-tiny": whisper_tiny,
    "pixtral-12b": pixtral_12b,
    "hymba-1.5b": hymba_1_5b,
    "rwkv6-3b": rwkv6_3b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
}

ARCH_IDS = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ARCH_IDS", "get_config", "ModelConfig"]
