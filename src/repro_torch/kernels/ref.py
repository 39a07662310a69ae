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
