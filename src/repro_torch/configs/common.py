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
    (a fresh ``default_rng(0)`` when None); ``kind="train"`` adds labels.
    vlm: ``seq_len - n_patches`` tokens after ``(batch, n_patches,
    d_model)`` standard-normal patch embeddings in the model dtype, and
    the ``(3, batch, seq_len)`` default positions.  encdec: ``(batch,
    n_frames, d_model)`` standard-normal stub frame embeddings in the
    model dtype, then ``seq_len`` decoder tokens."""
    require_ported(cfg)
    rng = rng if rng is not None else np.random.default_rng(0)
    out = {}
    if cfg.family == "encdec":
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.n_frames, cfg.d_model), dtype=np.float32)
        ).to(cfg.dtype)
    n_tok = seq_len - cfg.n_patches if cfg.family == "vlm" else seq_len
    out["tokens"] = torch.from_numpy(
        rng.integers(0, cfg.vocab, (batch, n_tok), dtype=np.int64))
    if cfg.family == "vlm":
        out["embeds"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model), dtype=np.float32)
        ).to(cfg.dtype)
        out["positions"] = torch.arange(seq_len)[None, None].expand(
            3, batch, seq_len).contiguous()
    if kind == "train":
        out["labels"] = torch.from_numpy(
            rng.integers(0, cfg.vocab, (batch, seq_len), dtype=np.int64))
    return out


def shrink(cfg: LMConfig, **over) -> LMConfig:
    """Reduced same-family config for CPU smoke tests (the reductions of
    the reference's ``shrink``)."""
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
    if cfg.family == "moe":
        # capacity_factor high enough that smoke runs never drop tokens
        # (decode-vs-forward equivalence relies on no-drop routing)
        d.update(n_experts=4, top_k=min(cfg.top_k, 2), capacity_factor=8.0)
    if cfg.family == "vlm":
        d.update(mrope_sections=(4, 2, 2), n_patches=4)
    if cfg.family == "hybrid":
        d.update(n_layers=5, local_window=16, head_dim=16, n_kv_heads=1)
    if cfg.family == "encdec":
        d.update(n_enc_layers=2, n_layers=2, n_frames=12, n_kv_heads=4)
    if cfg.family == "ssm":
        d.update(rwkv_head_dim=16)
    d.update(over)
    return dataclasses.replace(cfg, **d).validate()
