"""Shared config machinery, as in ``repro/configs/common.py``: the four
assigned input shapes of the dry-run and their input specs (``meta``
tensors: shapes and dtypes, no storage; the vision and audio frontends are
stubs providing precomputed embeddings), the smoke-test reduction helper
and small materialized batches."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..models.lm import LMConfig, require_ported


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def input_specs(cfg: LMConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input, keyed and shaped as the
    reference's ShapeDtypeStructs: tokens (and positions, labels) in the
    port's int64, embeds and frames in the model dtype.

    train/prefill: the full-sequence batch (+labels for train; vlm: the
    text after ``n_patches`` patch embeddings).  decode: one new token;
    the KV cache of ``seq_len`` is ``launch.steps.cache_shapes``'s."""
    b, s = shape.global_batch, shape.seq_len

    def meta(*dims, dtype=torch.int64):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": meta(b, 1)}
    batch: Dict[str, torch.Tensor] = {}
    if cfg.family == "vlm":
        batch["tokens"] = meta(b, s - cfg.n_patches)
        batch["embeds"] = meta(b, cfg.n_patches, cfg.d_model, dtype=cfg.dtype)
        batch["positions"] = meta(3, b, s)
    elif cfg.family == "encdec":
        batch["frames"] = meta(b, cfg.n_frames, cfg.d_model, dtype=cfg.dtype)
        batch["tokens"] = meta(b, s)
    else:
        batch["tokens"] = meta(b, s)
    if shape.kind == "train":
        batch["labels"] = meta(b, s)
    return batch


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
