"""Plain PyTorch versions of the package's CUDA kernels: the references the
kernels are held against, and what a wrapper runs for CPU tensors."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (B,Hq,S,D); k/v: (B,Hkv,T,D) -> (B,Hq,S,D), fp32 softmax.

    Queries are right-aligned: query i sits at absolute position
    qpos = T - S + i.  ``window`` (local attention): key kpos is visible
    only when kpos > qpos - window, the reference's mask
    (``repro/models/attention.py`` ``full_attention``).
    """
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, s, d).float()
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) / (d ** 0.5)
    qpos = torch.arange(s, device=q.device)[:, None] + (t - s)
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones(s, t, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    if causal or window is not None:
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


def rglru_scan_ref(a: torch.Tensor, g: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t h_{t-1} + g_t with an fp32 carry.  a/g: (B,S,R); h0:
    (B,R).  Returns (y (B,S,R) in a's dtype, h_last (B,R) fp32)."""
    h = h0.float()
    ys = []
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + g[:, t].float()
        ys.append(h)
    return torch.stack(ys, 1).to(a.dtype), h


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """Per-head WKV recurrence with an fp32 state.  r/k/v/w: (B,H,S,D);
    u: (H,D); s0: (B,H,D,D).  Per step
        y_t = r_t (S + diag(u) k_t^T v_t),  S <- diag(w_t) S + k_t^T v_t.
    Returns (y (B,H,S,D) in r's dtype, s_last (B,H,D,D) fp32)."""
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    state = s0.float()
    ys = []
    for t in range(r.shape[2]):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]       # (B,H,K,V)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, :, t],
                               state + uf * kv))
        state = wf[:, :, t, :, None] * state + kv
    return torch.stack(ys, 2).to(r.dtype), state


def matmul_qi8_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M,K) int8; w: (K,N) int8 -> (M,N) int32, exact.

    On the CPU the product is taken in int32.  CUDA has no integer matmul,
    so on a card it is taken in float64 and cast to int32, which is just as
    exact: each |x w| <= 2^14, so every partial sum of a K-long dot product
    is an integer of magnitude at most K 2^14, far below 2^53."""
    if x.device.type == "cuda":
        return (x.double() @ w.double()).to(torch.int32)
    return x.to(torch.int32) @ w.to(torch.int32)
