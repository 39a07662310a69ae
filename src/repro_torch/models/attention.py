"""Attention and norm primitives of the LM families, in PyTorch.

Ported from ``repro/models/attention.py`` with its numerics: bf16
activations with fp32 norm, RoPE and softmax arithmetic.  The model's
attention goes through the CUDA kernels
(:mod:`repro_torch.kernels.flash_attention` for a sequence,
:mod:`repro_torch.kernels.flash_decode` for one decode token);
:func:`full_attention`, :func:`decode_attention` and :func:`cross_attention`
are the plain references with the JAX module's exact rounding points.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with a zero-centred scale: ``x / rms(x) * (1 + scale)``."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm in fp32 (population variance), cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


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


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, sections,
                theta: float = 10000.0) -> torch.Tensor:
    """M-RoPE (qwen2-vl): the D/2 frequency slots split into ``sections``
    (temporal, height, width), each rotating with its own position stream;
    positions3: (3, ..., S).  The half-split rotation and fp32 angles of
    :func:`apply_rope`."""
    d = x.shape[-1]
    assert sum(sections) == d // 2, (sections, d)
    freqs = rope_freqs(d, theta, x.device)                    # (D/2,)
    parts, off = [], 0
    for i, sec in enumerate(sections):
        parts.append(positions3[i][..., None].float() * freqs[off:off + sec])
        off += sec
    ang = torch.cat(parts, dim=-1)[..., None, :]              # (..., S, 1, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, q_offset: int = 0,
                   window: Optional[int] = None) -> torch.Tensor:
    """Unchunked GQA attention; q: (B,S,Hq,D), k/v: (B,T,Hkv,D) -> (B,S,Hq,D).

    Scores and softmax in fp32, probabilities cast to v's dtype before the
    PV product, masked scores at -1e30: the JAX module's rounding points.
    ``window``: query i sees only keys within ``window`` positions of it."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    scores = scores / torch.sqrt(torch.tensor(float(d)))
    qpos = torch.arange(s, device=q.device)[:, None] + q_offset
    kpos = torch.arange(t, device=q.device)[None, :]
    masked = torch.zeros(s, t, dtype=torch.bool, device=q.device)
    if causal:
        masked |= kpos > qpos
    if window is not None:
        masked |= kpos <= qpos - window
    scores = scores.masked_fill(masked, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(b, s, hq, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token decode: q (B,1,Hq,D) against a (B,T,Hkv,D) cache.

    ``cache_len`` (an int, or a tensor broadcastable to (B, T) such as a
    per-slot ``ctx[:, None]``) is the number of valid cache entries; the
    new token's k/v must already be written at position cache_len-1;
    ``window`` keeps the last ``window`` of them.  The JAX module's
    rounding points, as in :func:`full_attention`."""
    b, _, hq, d = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, 1, hkv, hq // hkv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k_cache.float())
    scores = scores / torch.sqrt(torch.tensor(float(d)))
    kpos = torch.arange(t, device=q.device)[None, :]
    n = torch.as_tensor(cache_len, device=q.device)
    valid = kpos < n
    if window is not None:
        valid &= kpos >= n - window
    valid = valid.expand(b, t)
    scores = scores.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, hq, d).to(q.dtype)


def cross_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention over a fixed memory (whisper's decoder): q
    (B,S,Hq,D) against k/v (B,T,Hkv,D), any S and T, with
    :func:`full_attention`'s rounding points and no mask."""
    return full_attention(q, k, v, causal=False)
