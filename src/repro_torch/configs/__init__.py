"""Architecture registry of the port: ``get_config(arch)`` -> ModelConfig.

Only the archs whose whole serving path is ported are here; the reference's
others (``repro/configs/__init__.py``) wait for their slices.
"""

from __future__ import annotations

from repro_torch.configs import granite_3_8b
from repro_torch.configs.base import ModelConfig

_MODULES = {
    "granite-3-8b": granite_3_8b,
}

#: the reference's other archs, each waiting for a later slice of the port
NOT_PORTED = ("stablelm-1.6b", "starcoder2-3b", "deepseek-67b",
              "whisper-tiny", "pixtral-12b", "hymba-1.5b", "rwkv6-3b",
              "deepseek-moe-16b", "llama4-scout-17b-a16e")

ARCH_IDS = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        why = ("not ported yet (ROADMAP.md, Queue 1)" if name in NOT_PORTED
               else "unknown arch")
        raise KeyError(f"{name!r}: {why}; the port has {sorted(_MODULES)}")
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ARCH_IDS", "get_config", "ModelConfig"]
