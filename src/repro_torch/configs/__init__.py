"""Architecture registry of the port: ``get_config(arch)`` -> ModelConfig.

The reference's ten archs (``repro/configs/__init__.py``), each with its
full-size ``CONFIG`` and its ``SMOKE`` variant, field for field the same,
and the four shape cells with ``cell_applicable``.
"""

from __future__ import annotations

from typing import Tuple

from repro_torch.configs import (deepseek_67b, deepseek_moe_16b,
                                 granite_3_8b, hymba_1_5b,
                                 llama4_scout_17b_a16e, pixtral_12b,
                                 rwkv6_3b, stablelm_1_6b, starcoder2_3b,
                                 whisper_tiny)
from repro_torch.configs.base import (DECODE_32K, LONG_500K, PREFILL_32K,
                                      SHAPES, TRAIN_4K, ModelConfig,
                                      ShapeConfig)

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


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell runs, else the recorded skip reason."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skipped: pure full-attention arch; long_500k is run "
                       "only for sub-quadratic archs (DESIGN.md §5)")
    return True, ""


__all__ = ["ARCH_IDS", "get_config", "cell_applicable", "SHAPES",
           "ModelConfig", "ShapeConfig", "TRAIN_4K", "PREFILL_32K",
           "DECODE_32K", "LONG_500K"]
