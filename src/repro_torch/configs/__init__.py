"""Architecture registry: ``get(arch_id)`` -> config module.

Each module exposes ``config()`` (the exact assigned configuration) and
``smoke_config()`` (reduced same-family variant for CPU tests).  Only the
architectures whose family is ported are registered.
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict, List

from . import qwen3_1_7b
from .common import concrete_batch, shrink

_MODULES = (qwen3_1_7b,)

ARCHS: Dict[str, ModuleType] = {m.ARCH_ID: m for m in _MODULES}


def get(arch_id: str) -> ModuleType:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r} (or not ported to "
                       f"repro_torch yet); known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def arch_ids() -> List[str]:
    return list(ARCHS.keys())


__all__ = ["ARCHS", "get", "arch_ids", "concrete_batch", "shrink"]
