"""Whisper-tiny (arXiv:2212.04356), the encdec family, in PyTorch.

Ported from ``repro/models/whisper.py`` with its numerics.  The conv audio
frontend is a stub: the caller supplies precomputed frame embeddings
``(B, n_frames, d_model)``.  The backbone is modelled in full: encoder
layers (self-attention, GELU MLP), decoder layers (causal self-attention,
cross-attention over the encoder memory, GELU MLP), layer norm (fp32, eps
1e-5), biases on q, v, out and the MLP (none on k), sinusoidal positions
for encoder and decoder (fp32 table cast to the model dtype before it is
added), and the tied unembedding (in the model dtype, then fp32).

Every attention is a CUDA kernel (the plain versions on the CPU):

* encoder self-attention: :func:`flash_attention` non-causal, S = T =
  n_frames;
* decoder self-attention over a sequence: :func:`flash_attention` causal;
* cross-attention over a sequence: :func:`flash_attention` non-causal, S
  tokens against T = n_frames rows of the layer's memory K/V;
* a decode step: :func:`flash_decode` over the layer's self-attention
  cache (length ``len``) and over its memory K/V (every row).

The ``(B, S, H, D)`` projections go to the kernels as ``(B, H, S, D)``
views, as in :mod:`repro_torch.models.lm`.  Parameters mirror the JAX tree
with ``enc`` and ``dec`` lists of one dict per layer (the JAX tree stacks
them).  The decode cache holds ``k``/``v`` ``(L, B, max_len, Hkv, D)``,
written in place, the memory's ``mem_k``/``mem_v`` ``(L, B, n_frames, Hkv,
D)`` and one length ``len`` for the whole batch (an int).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention
from ..kernels.flash_decode import flash_decode
from . import attention as A
from .lm import LMConfig, _dense_init, embed_tokens, require_ported

Params = Dict[str, Any]


def _ln_params(d: int, dtype, device) -> Params:
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


def _ln(p: Params, x: torch.Tensor) -> torch.Tensor:
    return A.layer_norm(x, p["scale"], p["bias"])


def _attn_params(cfg: LMConfig, dtype, device, generator) -> Params:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return {"wq": _dense_init((d, qd), dtype, device, generator),
            "bq": torch.zeros(qd, dtype=dtype, device=device),
            "wk": _dense_init((d, kvd), dtype, device, generator),
            "wv": _dense_init((d, kvd), dtype, device, generator),
            "bv": torch.zeros(kvd, dtype=dtype, device=device),
            "wo": _dense_init((qd, d), dtype, device, generator),
            "bo": torch.zeros(d, dtype=dtype, device=device)}


def _mlp_params(cfg: LMConfig, dtype, device, generator) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {"wu": _dense_init((d, f), dtype, device, generator),
            "bu": torch.zeros(f, dtype=dtype, device=device),
            "wd": _dense_init((f, d), dtype, device, generator),
            "bd": torch.zeros(d, dtype=dtype, device=device)}


def init_params(cfg: LMConfig, device: torch.device,
                generator: Optional[torch.Generator] = None) -> Params:
    """Random parameters with the reference's shapes, dtypes and init
    scales (not its numbers: the generators differ).  ``generator`` must
    live on ``device``; ``device="meta"`` gives shapes without storage."""
    require_ported(cfg, "encdec")
    dtype, d = cfg.dtype, cfg.d_model

    def enc_layer():
        return {"ln1": _ln_params(d, dtype, device),
                "attn": _attn_params(cfg, dtype, device, generator),
                "ln2": _ln_params(d, dtype, device),
                "mlp": _mlp_params(cfg, dtype, device, generator)}

    def dec_layer():
        return {"ln1": _ln_params(d, dtype, device),
                "attn": _attn_params(cfg, dtype, device, generator),
                "ln_x": _ln_params(d, dtype, device),
                "xattn": _attn_params(cfg, dtype, device, generator),
                "ln2": _ln_params(d, dtype, device),
                "mlp": _mlp_params(cfg, dtype, device, generator)}

    return {
        "embed": _dense_init((cfg.vocab, d), dtype, device, generator,
                             scale=0.02),
        "enc": [enc_layer() for _ in range(cfg.n_enc_layers)],
        "enc_ln": _ln_params(d, dtype, device),
        "dec": [dec_layer() for _ in range(cfg.n_layers)],
        "dec_ln": _ln_params(d, dtype, device),
    }


def _sinusoid(cfg: LMConfig, seq: int, device, offset: int = 0
              ) -> torch.Tensor:
    """(seq, d_model) sin | cos table of positions offset .. offset + seq
    - 1, computed in fp32 and cast to the model dtype."""
    d = cfg.d_model
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None] \
        + offset
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None] / d
    ang = pos / torch.pow(10000.0, dim)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(cfg.dtype)


def _split_heads(cfg: LMConfig, x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, cfg.hd)


def _q(cfg: LMConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return _split_heads(cfg, x @ p["wq"] + p["bq"], cfg.n_heads)


def _kv(cfg: LMConfig, p: Params, x: torch.Tensor):
    return (_split_heads(cfg, x @ p["wk"], cfg.n_kv_heads),
            _split_heads(cfg, x @ p["wv"] + p["bv"], cfg.n_kv_heads))


def _out(cfg: LMConfig, p: Params, o: torch.Tensor) -> torch.Tensor:
    """(B, S, Hq, D) attention output -> the layer's (B, S, d_model)."""
    b, s = o.shape[:2]
    return o.reshape(b, s, cfg.q_dim) @ p["wo"] + p["bo"]


def _attend(cfg: LMConfig, p: Params, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, causal: bool) -> torch.Tensor:
    """(B, S, H, D) q and (B, T, Hkv, D) k/v through the flash kernel as
    (B, H, S, D) views."""
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal)
    return _out(cfg, p, o.transpose(1, 2))


def _self_attn(cfg: LMConfig, p: Params, x: torch.Tensor,
               causal: bool) -> torch.Tensor:
    return _attend(cfg, p, _q(cfg, p, x), *_kv(cfg, p, x), causal=causal)


def _cross_attn(cfg: LMConfig, p: Params, x: torch.Tensor,
                mem_k: torch.Tensor, mem_v: torch.Tensor) -> torch.Tensor:
    return _attend(cfg, p, _q(cfg, p, x), mem_k, mem_v, causal=False)


def _mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.gelu(x @ p["wu"] + p["bu"], approximate="tanh")
    return h @ p["wd"] + p["bd"]


def encode(cfg: LMConfig, params: Params,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, n_frames, d_model) stub embeddings -> the encoder
    memory (B, n_frames, d_model) on the parameters' device."""
    require_ported(cfg, "encdec")
    dev = params["embed"].device
    x = frames.to(dev, cfg.dtype) + _sinusoid(cfg, frames.shape[1], dev)
    for lp in params["enc"]:
        x = x + _self_attn(cfg, lp["attn"], _ln(lp["ln1"], x), causal=False)
        x = x + _mlp(lp["mlp"], _ln(lp["ln2"], x))
    return _ln(params["enc_ln"], x)


def _mem_kv(cfg: LMConfig, params: Params, memory: torch.Tensor):
    """Every decoder layer's cross K/V of the encoder memory: two (L, B,
    n_frames, Hkv, D) tensors."""
    kv = [_kv(cfg, lp["xattn"], memory) for lp in params["dec"]]
    return (torch.stack([k for k, _ in kv]),
            torch.stack([v for _, v in kv]))


def _decode_hidden(cfg: LMConfig, params: Params, tokens: torch.Tensor,
                   memory: torch.Tensor) -> torch.Tensor:
    """The teacher-forced decoder stack -> post-layer hidden states."""
    x = embed_tokens(cfg, params, tokens)
    x = x + _sinusoid(cfg, tokens.shape[1], x.device)
    mem_k, mem_v = _mem_kv(cfg, params, memory)
    for lp, mk, mv in zip(params["dec"], mem_k, mem_v):
        x = x + _self_attn(cfg, lp["attn"], _ln(lp["ln1"], x), causal=True)
        x = x + _cross_attn(cfg, lp["xattn"], _ln(lp["ln_x"], x), mk, mv)
        x = x + _mlp(lp["mlp"], _ln(lp["ln2"], x))
    return x


def unembed(cfg: LMConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """The final layer norm and the tied unembedding (in the model dtype)
    -> fp32 logits."""
    x = _ln(params["dec_ln"], x)
    return (x @ params["embed"].T).float()


def decode_train(cfg: LMConfig, params: Params, tokens: torch.Tensor,
                 memory: torch.Tensor,
                 last_token_only: bool = False) -> torch.Tensor:
    """Teacher-forced decoder pass over (B, S) tokens -> fp32 logits (B, S,
    V), or (B, 1, V) with ``last_token_only`` (sliced before the final
    norm)."""
    require_ported(cfg, "encdec")
    x = _decode_hidden(cfg, params, tokens, memory)
    if last_token_only:
        x = x[:, -1:]
    return unembed(cfg, params, x)


def forward(cfg: LMConfig, params: Params, batch: Dict[str, torch.Tensor],
            last_token_only: bool = False) -> torch.Tensor:
    """batch["frames"] (B, n_frames, d_model), batch["tokens"] (B, S) ->
    fp32 logits."""
    memory = encode(cfg, params, batch["frames"])
    return decode_train(cfg, params, batch["tokens"], memory,
                        last_token_only=last_token_only)


def forward_hidden(cfg: LMConfig, params: Params,
                   batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Post-layer decoder hidden states: pair with :func:`unembed`."""
    memory = encode(cfg, params, batch["frames"])
    return _decode_hidden(cfg, params, batch["tokens"], memory)


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------
def init_cache(cfg: LMConfig, batch: int, max_len: int, device,
               memory: Optional[torch.Tensor] = None,
               params: Optional[Params] = None) -> Params:
    """Zero self-attention caches (n_layers, B, max_len, Hkv, D) in the
    model dtype, length 0, and the memory's cross K/V: from ``memory``
    (:func:`encode`'s) through ``params`` when both are given, else zeros
    of (n_layers, B, n_frames, Hkv, D), as the reference's (a decode step
    then attends an all-zero memory)."""
    require_ported(cfg, "encdec")
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    cache: Params = {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                     "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
                     "len": 0}
    if memory is not None and params is not None:
        cache["mem_k"], cache["mem_v"] = _mem_kv(cfg, params, memory)
    else:
        mshape = (cfg.n_layers, batch, cfg.n_frames, cfg.n_kv_heads, cfg.hd)
        cache["mem_k"] = torch.zeros(mshape, dtype=cfg.dtype, device=device)
        cache["mem_v"] = torch.zeros(mshape, dtype=cfg.dtype, device=device)
    return cache


def forward_decode(cfg: LMConfig, params: Params, tokens: torch.Tensor,
                   cache: Params) -> Tuple[torch.Tensor, Params]:
    """One decode step: tokens (B, 1) at position ``len`` -> fp32 logits
    (B, 1, V) and the cache with its length advanced; the self-attention
    K/V are written in place at row ``len``."""
    require_ported(cfg, "encdec")
    n = cache["len"] + 1
    x = embed_tokens(cfg, params, tokens)
    x = x + _sinusoid(cfg, 1, x.device, offset=n - 1)
    for i, lp in enumerate(params["dec"]):
        p, kc, vc = lp["attn"], cache["k"][i], cache["v"][i]
        h = _ln(lp["ln1"], x)
        q = _q(cfg, p, h)
        k, v = _kv(cfg, p, h)
        kc[:, n - 1] = k[:, 0]
        vc[:, n - 1] = v[:, 0]
        o = flash_decode(q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2), n)
        x = x + _out(cfg, p, o[:, None])
        p = lp["xattn"]
        mk, mv = cache["mem_k"][i], cache["mem_v"][i]
        q = _q(cfg, p, _ln(lp["ln_x"], x))
        o = flash_decode(q[:, 0], mk.transpose(1, 2), mv.transpose(1, 2),
                         mk.shape[1])
        x = x + _out(cfg, p, o[:, None])
        x = x + _mlp(lp["mlp"], _ln(lp["ln2"], x))
    return unembed(cfg, params, x), {**cache, "len": n}
