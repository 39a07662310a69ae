"""Architecture registry: ``get(arch_id)`` -> config module.

Each module exposes ``config()`` (the exact assigned configuration),
``smoke_config()`` (reduced same-family variant for CPU tests) and
``SKIP_SHAPES`` (shape_name -> reason, per the long_500k rule).  Every
reference architecture is registered, in the reference's order.
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict, List

from . import (granite_moe_1b, minitron_4b, phi3_5_moe_42b, phi3_mini_3_8b,
               qwen2_5_14b, qwen2_vl_72b, qwen3_1_7b, recurrentgemma_9b,
               rwkv6_1_6b, whisper_tiny)
from .common import SHAPES, ShapeSpec, concrete_batch, input_specs, shrink

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


def cells(include_skipped: bool = False):
    """All (arch_id, shape_name, skip reason or None) dry-run cells; the
    skipped ones only with ``include_skipped``."""
    out = []
    for aid, mod in ARCHS.items():
        for sname in SHAPES:
            skip = mod.SKIP_SHAPES.get(sname)
            if skip is None or include_skipped:
                out.append((aid, sname, skip))
    return out


__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "get", "arch_ids", "cells",
           "input_specs", "concrete_batch", "shrink"]
