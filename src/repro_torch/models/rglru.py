"""RecurrentGemma / Griffin hybrid (arXiv:2402.19427), in PyTorch.

Ported from ``repro/models/rglru.py`` with its numerics.  Layer i is local
sliding-window attention (MQA, head_dim 256, window ``local_window``) when
``i % attn_every == attn_every - 1``, otherwise a recurrent block: value and
GELU-gate projections, a causal depthwise conv (width ``conv_width``) and
the RG-LRU diagonal recurrence

    r_t = sigma(w_a x_t + b_a),  i_t = sigma(w_i x_t + b_i)
    log a_t = -c softplus(Lambda) r_t   (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

in fp32.  Every layer carries a geglu MLP.  Layers are grouped as in the
reference: ``super`` is a list of (rec1, rec2, attn) super-blocks and
``tail`` a list of trailing rec blocks (38 = 12 x 3 + 2).

Every rec layer's recurrence goes through
:func:`repro_torch.kernels.rglru_scan.rglru_scan` (the CUDA kernel on the
card, its plain version on the CPU) and every attention layer through the
flash kernels of :mod:`repro_torch.models.lm` (``attn_block`` for a prompt
of any length, its keys masked to the last ``local_window`` positions;
``attn_block_decode`` over the ring cache of min(max_len, window) rows for
a decode token).

Decode state: the conv tail (W - 1 inputs) and the fp32 LRU h per rec
layer, a ring KV cache per attention layer.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.rglru_scan import rglru_scan
from . import attention as A
from . import lm
from .lm import LMConfig, _dense_init, require_ported

Params = Dict[str, Any]
LRU_C = 8.0


def n_super_and_tail(n_layers: int, attn_every: int) -> Tuple[int, int]:
    n_super = n_layers // attn_every
    return n_super, n_layers - n_super * attn_every


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_rec_block(cfg: LMConfig, dtype, device, generator) -> Params:
    d = r = cfg.d_model                             # lru width == d_model

    def f32(value):
        return torch.full((r,), value, dtype=torch.float32, device=device)

    return {
        "ln1": {"scale": torch.zeros(d, dtype=dtype, device=device)},
        "ln2": {"scale": torch.zeros(d, dtype=dtype, device=device)},
        "rec": {
            "wx": _dense_init((d, r), dtype, device, generator),
            "wgate": _dense_init((d, r), dtype, device, generator),
            "conv_w": _dense_init((cfg.conv_width, r), dtype, device,
                                  generator, 0.3),
            "conv_b": torch.zeros(r, dtype=dtype, device=device),
            "a_gate_w": f32(1.0), "a_gate_b": f32(0.0),
            "i_gate_w": f32(1.0), "i_gate_b": f32(0.0),
            "lam": f32(1.0),
            "wo": _dense_init((r, d), dtype, device, generator),
        },
        "mlp": lm.mlp_params(cfg, dtype, device, generator),
    }


def init_params(cfg: LMConfig, device: torch.device,
                generator: Optional[torch.Generator] = None) -> Params:
    """Random parameters with the reference's shapes, dtypes and init
    scales (not its numbers).  ``device="meta"`` gives shapes only."""
    require_ported(cfg, "hybrid")
    dtype = cfg.dtype
    n_super, tail = n_super_and_tail(cfg.n_layers, cfg.attn_every)
    params: Params = {
        "embed": _dense_init((cfg.vocab, cfg.d_model), dtype, device,
                             generator, 0.02),
        "super": [{"rec1": init_rec_block(cfg, dtype, device, generator),
                   "rec2": init_rec_block(cfg, dtype, device, generator),
                   "attn": lm.block_params(cfg, dtype, device, generator)}
                  for _ in range(n_super)],
        "final_norm": {"scale": torch.zeros(cfg.d_model, dtype=dtype,
                                            device=device)},
    }
    if tail:
        params["tail"] = [init_rec_block(cfg, dtype, device, generator)
                          for _ in range(tail)]
    if not cfg.tie_embeddings:
        params["head"] = _dense_init((cfg.d_model, cfg.vocab), dtype, device,
                                     generator)
    return params


# ---------------------------------------------------------------------------
# RG-LRU + conv
# ---------------------------------------------------------------------------
def _causal_conv(p: Params, x: torch.Tensor,
                 carry: Optional[torch.Tensor] = None):
    """Per-channel causal conv of width W in x's dtype, summed in tap
    order.  carry: (B, W-1, R) previous inputs.  Returns (y, new carry)."""
    w = p["conv_w"].shape[0]
    if carry is None:
        carry = x.new_zeros((x.shape[0], w - 1, x.shape[-1]))
    xp = torch.cat([carry, x], dim=1)                # (B, S+W-1, R)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * p["conv_w"][i] for i in range(w))
    return y + p["conv_b"], xp[:, -(w - 1):]


def rg_lru(p: Params, x: torch.Tensor, h0: torch.Tensor):
    """x: (B, S, R); h0: (B, R) fp32.  Returns (y in x's dtype, h_last)."""
    xf = x.float()
    r = torch.sigmoid(xf * p["a_gate_w"] + p["a_gate_b"])
    i = torch.sigmoid(xf * p["i_gate_w"] + p["i_gate_b"])
    a = torch.exp(-LRU_C * F.softplus(p["lam"]) * r)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    y, h_last = rglru_scan(a, gated, h0)
    return y.to(x.dtype), h_last


def rec_temporal(cfg: LMConfig, p: Params, x: torch.Tensor, state: Params):
    """Recurrent temporal mixing.  state: {"conv": (B, W-1, R), "h": (B,
    R) fp32}."""
    val = x @ p["wx"]
    gate = F.gelu(x @ p["wgate"], approximate="tanh")
    val, conv_carry = _causal_conv(p, val, state["conv"])
    y, h_last = rg_lru(p, val, state["h"])
    return (y * gate) @ p["wo"], {"conv": conv_carry, "h": h_last}


def _zero_rec_state(cfg: LMConfig, b: int, device) -> Params:
    r = cfg.d_model
    return {"conv": torch.zeros((b, cfg.conv_width - 1, r), dtype=cfg.dtype,
                                device=device),
            "h": torch.zeros((b, r), dtype=torch.float32, device=device)}


def rec_layer(cfg: LMConfig, bp: Params, x: torch.Tensor, state: Params):
    out, state = rec_temporal(cfg, bp["rec"],
                              A.rms_norm(x, bp["ln1"]["scale"]), state)
    x = x + out
    x = x + lm.mlp_block(cfg, bp["mlp"], A.rms_norm(x, bp["ln2"]["scale"]))
    return x, state


def _attn_layer(cfg: LMConfig, ab: Params, x: torch.Tensor,
                attend) -> torch.Tensor:
    x = x + attend(A.rms_norm(x, ab["ln1"]["scale"]))
    return x + lm.mlp_block(cfg, ab["mlp"], A.rms_norm(x, ab["ln2"]["scale"]))


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------
def forward_hidden(cfg: LMConfig, params: Params,
                   batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Post-block hidden states (B, S, D): pair with :func:`unembed`."""
    require_ported(cfg, "hybrid")
    x = lm.embed_tokens(cfg, params, batch["tokens"])
    positions = lm.positions_for(x)
    zero = _zero_rec_state(cfg, x.shape[0], x.device)
    for sb in params["super"]:
        x, _ = rec_layer(cfg, sb["rec1"], x, zero)
        x, _ = rec_layer(cfg, sb["rec2"], x, zero)
        x = _attn_layer(cfg, sb["attn"], x, lambda h, ab=sb["attn"]:
                        lm.attn_block(cfg, ab["attn"], h, positions,
                                      window=cfg.local_window))
    for bp in params.get("tail", []):
        x, _ = rec_layer(cfg, bp, x, zero)
    return x


def unembed(cfg: LMConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    return lm.unembed(cfg, params, x)


def forward(cfg: LMConfig, params: Params, batch: Dict[str, torch.Tensor],
            last_token_only: bool = False) -> torch.Tensor:
    """Full-sequence forward -> fp32 logits (B, S, V), or (B, 1, V) with
    ``last_token_only``."""
    x = forward_hidden(cfg, params, batch)
    if last_token_only:
        x = x[:, -1:]
    return unembed(cfg, params, x)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device: torch.device) -> Params:
    """Zero rec states and ring K/V caches (n_super, B, min(max_len,
    window), Hkv, D) in the model dtype, and the length 0."""
    require_ported(cfg, "hybrid")
    n_super, tail = n_super_and_tail(cfg.n_layers, cfg.attn_every)
    t = min(max_len, cfg.local_window)
    shape = (n_super, batch, t, cfg.n_kv_heads, cfg.hd)
    cache: Params = {
        "rec1": [_zero_rec_state(cfg, batch, device) for _ in range(n_super)],
        "rec2": [_zero_rec_state(cfg, batch, device) for _ in range(n_super)],
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "len": 0,
    }
    if tail:
        cache["tail"] = [_zero_rec_state(cfg, batch, device)
                         for _ in range(tail)]
    return cache


def forward_decode(cfg: LMConfig, params: Params, tokens: torch.Tensor,
                   cache: Params) -> Tuple[torch.Tensor, Params]:
    """One decode step: tokens (B, 1) -> fp32 logits (B, 1, V) and the new
    cache; the ring K/V tensors are written in place."""
    require_ported(cfg, "hybrid")
    x = lm.embed_tokens(cfg, params, tokens)
    n = cache["len"] + 1
    pos = torch.full((1, 1), n - 1, device=x.device)
    rec1, rec2 = [], []
    for i, sb in enumerate(params["super"]):
        x, st1 = rec_layer(cfg, sb["rec1"], x, cache["rec1"][i])
        x, st2 = rec_layer(cfg, sb["rec2"], x, cache["rec2"][i])
        rec1.append(st1)
        rec2.append(st2)
        x = _attn_layer(cfg, sb["attn"], x, lambda h, ab=sb["attn"], i=i:
                        lm.attn_block_decode(cfg, ab["attn"], h,
                                             cache["k"][i], cache["v"][i], n,
                                             pos, window=cfg.local_window))
    new_cache = dict(cache, rec1=rec1, rec2=rec2, len=n)
    if "tail" in params:
        new_cache["tail"] = []
        for bp, st in zip(params["tail"], cache["tail"]):
            x, st = rec_layer(cfg, bp, x, st)
            new_cache["tail"].append(st)
    return unembed(cfg, params, x), new_cache
