"""Architecture registry: ``get(arch_id)`` -> config module.

Each module exposes ``config()`` (the exact assigned configuration) and
``smoke_config()`` (reduced same-family variant for CPU tests).  Every
reference architecture is registered, in the reference's order.
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict, List

from . import (granite_moe_1b, minitron_4b, phi3_5_moe_42b, phi3_mini_3_8b,
               qwen2_5_14b, qwen2_vl_72b, qwen3_1_7b, recurrentgemma_9b,
               rwkv6_1_6b, whisper_tiny)
from .common import concrete_batch, shrink

_MODULES = (qwen2_5_14b, qwen3_1_7b, phi3_mini_3_8b, minitron_4b,
            qwen2_vl_72b, granite_moe_1b, phi3_5_moe_42b, whisper_tiny,
            recurrentgemma_9b, rwkv6_1_6b)

ARCHS: Dict[str, ModuleType] = {m.ARCH_ID: m for m in _MODULES}


def get(arch_id: str) -> ModuleType:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def arch_ids() -> List[str]:
    return list(ARCHS.keys())


__all__ = ["ARCHS", "get", "arch_ids", "concrete_batch", "shrink"]
