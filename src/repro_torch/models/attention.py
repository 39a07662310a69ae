"""Attention and norm primitives of the dense LM family, in PyTorch.

Ported from ``repro/models/attention.py`` with its numerics: bf16
activations with fp32 norm, RoPE and softmax arithmetic.  The model's
attention goes through the CUDA flash kernel
(:mod:`repro_torch.kernels.flash_attention`); :func:`full_attention` is the
plain reference with the JAX module's exact rounding points.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with a zero-centred scale: ``x / rms(x) * (1 + scale)``."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).

    Half-split rotation: dims [0, D/2) pair with [D/2, D)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (D/2,)
    ang = positions[..., None].float() * freqs                # (..., S, D/2)
    ang = ang[..., None, :]                                   # (..., S, 1, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Unchunked GQA attention; q: (B,S,Hq,D), k/v: (B,T,Hkv,D) -> (B,S,Hq,D).

    Scores and softmax in fp32, probabilities cast to v's dtype before the
    PV product, masked scores at -1e30: the JAX module's rounding points."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    scores = scores / torch.sqrt(torch.tensor(float(d)))
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None] + q_offset
        kpos = torch.arange(t, device=q.device)[None, :]
        scores = scores.masked_fill(kpos > qpos, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(b, s, hq, d).to(q.dtype)
