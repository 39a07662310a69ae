"""Plain PyTorch versions of the package's CUDA kernels: the references the
kernels are held against, and what a wrapper runs for CPU tensors."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            window: Optional[int]) -> torch.Tensor:
    """fp32 scaled, masked scores (B, Hkv, G, S, T) of q grouped by kv
    head.  Queries are right-aligned: query i sits at absolute position
    qpos = T - S + i.  ``window`` (local attention): key kpos is visible
    only when kpos > qpos - window, the reference's mask
    (``repro/models/attention.py`` ``full_attention``).  Masked pairs hold
    NEG_INF."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, s, d).float()
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) / (d ** 0.5)
    if causal or window is not None:
        qpos = torch.arange(s, device=q.device)[:, None] + (t - s)
        kpos = torch.arange(t, device=q.device)[None, :]
        mask = torch.ones(s, t, dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        scores = scores.masked_fill(~mask, NEG_INF)
    return scores


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: Optional[int] = None,
                        return_lse: bool = False):
    """q: (B,Hq,S,D); k/v: (B,Hkv,T,D) -> (B,Hq,S,D), fp32 softmax over
    :func:`_scores`.

    ``return_lse``: also return the fp32 (B, Hq, S) log-sum-exp of each
    query's scaled, masked scores, which the backward recomputes the
    probabilities from (:func:`flash_attention_bwd_ref`)."""
    b, hq, s, d = q.shape
    scores = _scores(q, k, causal, window)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v.float())
    out = out.reshape(b, hq, s, d).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(scores, dim=-1).reshape(b, hq, s)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lse: torch.Tensor,
                            do: torch.Tensor, causal: bool = True,
                            window: Optional[int] = None):
    """The gradient of :func:`flash_attention_ref` with respect to q, k and
    v, given the forward's ``lse`` (fp32 (B, Hq, S)) and the output's
    gradient ``do``, step by step in fp32 (the FlashAttention-2 backward):

        P  = exp(scale Q K^T - lse), 0 where masked
        dV = sum over the group's q heads of P^T dO
        dP = dO V^T
        D  = rowsum(P * dP)
        dS = P * (dP - D)
        dQ = scale dS K
        dK = scale * sum over the group's q heads of dS^T Q

    D is the row sum of P * dP over the recomputed fp32 P, which equals
    FlashAttention-2's rowsum(dO * O) for the exact output.  An output whose
    P was rounded to bf16 before P V (the bf16 kernel's) would carry that
    rounding into every element of a row's dS, and so into dQ and dK along
    the row's mean key; this D keeps the gradient that of the recomputed
    softmax.  Returns (dq, dk, dv) in the inputs' dtype."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = d ** -0.5
    grouped = lambda x: x.reshape(b, hkv, g, s, d).float()  # noqa: E731
    qg, dog = grouped(q), grouped(do)
    kf, vf = k.float(), v.float()
    # masked pairs: exp(NEG_INF - lse) is exactly 0
    p = torch.exp(_scores(q, k, causal, window)
                  - lse.reshape(b, hkv, g, s, 1).float())
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dog)
    dp = torch.einsum("bkgsd,bktd->bkgst", dog, vf)
    delta = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, kf) * scale
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qg) * scale
    return (dq.reshape(b, hq, s, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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


RGLRU_PIECE = 64    # steps between the checkpoints of the backward


def rglru_scan_checkpoints_ref(a: torch.Tensor, g: torch.Tensor,
                               h0: torch.Tensor) -> torch.Tensor:
    """The carry at the start of every piece of RGLRU_PIECE steps of
    :func:`rglru_scan_ref`'s recurrence: (B, ceil(S / 64), R) fp32, piece
    p the carry after 64p steps (h0 for p = 0).  The forward kernel's
    checkpoint epilogue writes the same, and the backward starts each
    piece from them."""
    h = h0.float()
    out = []
    for t in range(a.shape[1]):
        if t % RGLRU_PIECE == 0:
            out.append(h)
        h = a[:, t].float() * h + g[:, t].float()
    return torch.stack(out, 1)


def rglru_scan_bwd_ref(a: torch.Tensor, g: torch.Tensor, h0: torch.Tensor,
                       dy: Optional[torch.Tensor],
                       dh_last: Optional[torch.Tensor],
                       checkpoints: Optional[torch.Tensor] = None):
    """The gradient of :func:`rglru_scan_ref` with respect to a, g and h0,
    given the gradients ``dy`` of y and ``dh_last`` of h_last (None:
    zero), as the reverse recurrence per channel:

        G_t  = dy_t + a_{t+1} G_{t+1},   G_{S-1} = dy_{S-1} + dh_last
        dg_t = G_t,   da_t = G_t h_{t-1} (h_{-1} = h0),   dh0 = a_0 G_0

    The fp32 carry h_{t-1} is recomputed from a, g and h0, whatever the
    inputs' dtype, never read from the (rounded) output.  With
    ``checkpoints`` (:func:`rglru_scan_checkpoints_ref`'s, or the forward
    kernel's) each piece of 64 steps recomputes it from its own start, as
    the backward kernel does, not from the previous piece's end; the same
    values, since both take the same steps.  Returns (da, dg) in a's and
    g's dtype and dh0 fp32."""
    af, gf = a.float(), g.float()
    h = h0.float()
    prev = []                                       # h_{t-1}
    for t in range(a.shape[1]):
        if checkpoints is not None and t % RGLRU_PIECE == 0:
            h = checkpoints[:, t // RGLRU_PIECE].float()
        prev.append(h)
        h = af[:, t] * h + gf[:, t]
    grad = (torch.zeros_like(h0, dtype=torch.float32) if dh_last is None
            else dh_last.float())
    da, dg = torch.empty_like(af), torch.empty_like(af)
    for t in reversed(range(a.shape[1])):
        if dy is not None:
            grad = grad + dy[:, t].float()
        dg[:, t] = grad
        da[:, t] = grad * prev[t]
        grad = af[:, t] * grad
    return da.to(a.dtype), dg.to(g.dtype), grad


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


RWKV6_PIECE = 8     # steps between the checkpoints of the backward


def rwkv6_scan_states_ref(k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                          s0: torch.Tensor) -> torch.Tensor:
    """The state at the start of every piece of RWKV6_PIECE steps of
    :func:`rwkv6_scan_ref`'s recurrence: (B, H, ceil(S / 8), D, D) fp32,
    piece p the state after 8p steps (s0 for p = 0), each step
    ``S <- w_t S + k_t^T v_t`` in the order :func:`rwkv6_scan_bwd_ref`
    recomputes it.  The forward kernel's checkpoint epilogue writes the
    same, and the backward starts each piece from them."""
    kf, vf, wf = (x.float() for x in (k, v, w))
    state = s0.float()
    out = []
    for t in range(k.shape[2]):
        if t % RWKV6_PIECE == 0:
            out.append(state)
        state = (wf[:, :, t, :, None] * state
                 + kf[:, :, t, :, None] * vf[:, :, t, None, :])
    return torch.stack(out, 2)


def rwkv6_scan_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                       dy: Optional[torch.Tensor],
                       ds_last: Optional[torch.Tensor],
                       states: Optional[torch.Tensor] = None):
    """The gradient of :func:`rwkv6_scan_ref` with respect to r, k, v, w, u
    and s0, given the gradients ``dy`` of y and ``ds_last`` of s_last
    (None: zero), as the explicit reverse recurrence.  With S_t the state
    after step t (S_{-1} = s0) and G_t = dL/dS_t (G_{S-1} = ds_last):

        dr_t = S_{t-1} dy_t + (u * k_t)(v_t . dy_t)
        dk_t = G_t v_t + (r_t * u)(v_t . dy_t)
        dv_t = G_t^T k_t + (r_t . (u * k_t)) dy_t
        dw_t = rowsum(G_t * S_{t-1})
        du   = sum over batch and time of r_t * k_t (v_t . dy_t)
        G_{t-1} = diag(w_t) G_t + r_t dy_t^T,   ds0 = G_{-1}

    No step divides by a decay, so decays of 0 and 1 are exact.
    ``states`` (:func:`rwkv6_scan_states_ref`'s, or the forward kernel's
    checkpoints): each piece of 8 steps recomputes S from its own start,
    as the backward kernel does, not from the previous piece's end; the
    same values, since both take the same steps.  Returns (dr, dk, dv, dw)
    in the inputs' dtype and (du, ds0) fp32."""
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None]                                   # (1, H, D)
    state = s0.float()
    before = []                                            # S_{t-1}
    for t in range(r.shape[2]):
        if states is not None and t % RWKV6_PIECE == 0:
            state = states[:, :, t // RWKV6_PIECE].float()
        before.append(state)
        state = (wf[:, :, t, :, None] * state
                 + kf[:, :, t, :, None] * vf[:, :, t, None, :])
    grad = (torch.zeros_like(state) if ds_last is None
            else ds_last.float())
    dyf = torch.zeros_like(vf) if dy is None else dy.float()
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros_like(uf[0])
    for t in reversed(range(r.shape[2])):
        r_t, k_t, v_t, w_t, dy_t = (x[:, :, t] for x in (rf, kf, vf, wf,
                                                         dyf))
        vdy = (v_t * dy_t).sum(-1, keepdim=True)           # (B, H, 1)
        dr[:, :, t] = (torch.einsum("bhkv,bhv->bhk", before[t], dy_t)
                       + uf * k_t * vdy)
        dk[:, :, t] = (torch.einsum("bhkv,bhv->bhk", grad, v_t)
                       + r_t * uf * vdy)
        dv[:, :, t] = (torch.einsum("bhkv,bhk->bhv", grad, k_t)
                       + (r_t * uf * k_t).sum(-1, keepdim=True) * dy_t)
        dw[:, :, t] = (grad * before[t]).sum(-1)
        du = du + (r_t * k_t * vdy).sum(0)
        grad = w_t[..., None] * grad + r_t[..., None] * dy_t[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du, grad)


def matmul_qi8_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M,K) int8; w: (K,N) int8 -> (M,N) int32, exact.

    On the CPU the product is taken in int32.  CUDA has no integer matmul,
    so on a card it is taken in float64 and cast to int32, which is just as
    exact: each |x w| <= 2^14, so every partial sum of a K-long dot product
    is an integer of magnitude at most K 2^14, far below 2^53."""
    if x.device.type == "cuda":
        return (x.double() @ w.double()).to(torch.int32)
    return x.to(torch.int32) @ w.to(torch.int32)


BN_EPS = 1e-3
# the activations a bn_epilogue call applies, as the CNN forward's act
# nodes compute them
EPILOGUE_ACTS = {"relu": torch.relu,
                 "relu6": lambda v: torch.clamp(v, 0, 6)}


def bn_epilogue_ref(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                    gamma: torch.Tensor, beta: torch.Tensor,
                    r: Optional[torch.Tensor] = None,
                    act: Optional[str] = None) -> torch.Tensor:
    """Inference BatchNorm over the last axis of ``x`` (eps 1e-3), then
    ``+ r`` and ``act`` ("relu", "relu6" or None) where given: the CNN
    forward's ``bn``, ``add`` and ``act`` nodes, op for op."""
    inv = torch.rsqrt(var + BN_EPS)
    y = (x - mean) * inv * gamma + beta
    if r is not None:
        y = y + r
    return y if act is None else EPILOGUE_ACTS[act](y)


def dwconv_ref(x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None, stride: int = 1,
               pads: Tuple[int, int, int, int] = (0, 0, 0, 0),
               bn: Optional[Sequence[torch.Tensor]] = None,
               act: Optional[str] = None) -> torch.Tensor:
    """Depthwise convolution of NHWC ``x`` (N, H, W, C) by ``w`` (C, 1, k,
    k), plus ``b`` (C,) where given, after zero padding ``pads`` (``F.pad``'s
    order: left, right, top, bottom) -> (N, OH, OW, C): the CNN forward's
    depthwise ops, x viewed NCHW, ``F.pad``, a grouped ``F.conv2d``, the
    result viewed NHWC.  Given ``bn`` = (mean, var, gamma, beta), then
    :func:`bn_epilogue_ref` of the result with ``act``: the forward's
    ``bn`` and ``act`` nodes after the conv, op for op."""
    v = x.permute(0, 3, 1, 2)
    if any(pads):
        v = F.pad(v, pads)
    y = F.conv2d(v, w, b, stride=stride,
                 groups=x.shape[-1]).permute(0, 2, 3, 1)
    return y if bn is None else bn_epilogue_ref(y, *bn, act=act)
