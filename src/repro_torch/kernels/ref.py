"""Plain PyTorch versions of the package's CUDA kernels: the references the
kernels are held against, and what a wrapper runs for CPU tensors."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q: (B,Hq,S,D); k/v: (B,Hkv,T,D) -> (B,Hq,S,D), fp32 softmax.

    Queries are right-aligned: query i sits at absolute position T - S + i.
    """
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, s, d).float()
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) / (d ** 0.5)
    if causal:
        mask = torch.ones(s, t, dtype=torch.bool,
                          device=q.device).tril(diagonal=t - s)
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v.float())
    return out.reshape(b, hq, s, d).to(q.dtype)


def decode_lengths(cache_len, b: int, device) -> torch.Tensor:
    """``cache_len`` (an int, a 0-d tensor or a ``(B,)`` tensor) as a
    ``(B,)`` int32 tensor on ``device``."""
    lens = torch.as_tensor(cache_len, dtype=torch.int32, device=device)
    if lens.dim() == 0:
        return lens.expand(b)
    if lens.shape != (b,):
        raise ValueError(f"cache_len must be an int or a ({b},) tensor; "
                         f"got shape {tuple(lens.shape)}")
    return lens


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len) -> torch.Tensor:
    """Single-token cached attention, fp32 softmax.  q: (B,Hq,D); caches
    (B,Hkv,T,D); ``cache_len``: an int or a (B,) per-slot length (cache
    positions [0, len) are valid; a length above T means all T).

    A slot of length 0 gives zeros, as the TPU kernel does (its skipped
    blocks leave the softmax denominator at 0)."""
    b, hq, d = q.shape
    hkv, t = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    lens = decode_lengths(cache_len, b, q.device)
    qg = q.reshape(b, hkv, g, d).float()
    scores = torch.einsum("bkgd,bktd->bkgt", qg,
                          k_cache.float()) / (d ** 0.5)
    valid = torch.arange(t, device=q.device)[None, :] < lens[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", probs, v_cache.float())
    out = out * (lens > 0).float()[:, None, None, None]
    return out.reshape(b, hq, d).to(q.dtype)
