"""Shared config machinery: the smoke-test reduction helper and small
materialized batches, as in ``repro/configs/common.py``."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..models.lm import LMConfig, require_ported


def concrete_batch(cfg: LMConfig, seq_len: int, batch: int,
                   rng: Optional[np.random.Generator] = None,
                   kind: str = "train") -> Dict[str, torch.Tensor]:
    """Materialized (small) batch of CPU int64 tokens, drawn from ``rng``
    (a fresh ``default_rng(0)`` when None); ``kind="train"`` adds labels."""
    require_ported(cfg)
    rng = rng if rng is not None else np.random.default_rng(0)
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (batch, seq_len), dtype=np.int64))}
    if kind == "train":
        out["labels"] = torch.from_numpy(
            rng.integers(0, cfg.vocab, (batch, seq_len), dtype=np.int64))
    return out


def shrink(cfg: LMConfig, **over) -> LMConfig:
    """Reduced same-family config for CPU smoke tests (the dense family's
    reductions of the reference's ``shrink``)."""
    d = dict(
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 4),
        d_model=64, d_ff=128, vocab=512,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        q_chunk=32,
        remat=False,
        dtype=torch.float32,
    )
    d.update(over)
    return dataclasses.replace(cfg, **d).validate()
