"""RWKV6 "Finch" (arXiv:2404.05892), the ssm family, in PyTorch.

Ported from ``repro/models/rwkv6.py`` with its numerics.  Per layer:

* **time-mix**: token shift with data-dependent interpolation (ddlerp via a
  low-rank adapter), projections r/k/v/gate, data-dependent per-channel
  decay ``w_t = exp(-exp(w0 + lora_w(x)))`` (the lora in the model dtype,
  then + the fp32 ``w0``), and the WKV recurrence per head (head_dim 64)
  with an fp32 state
      y_t = r_t (S + diag(u) k_t^T v_t),   S <- diag(w_t) S + k_t^T v_t
  followed by the ``ln_x`` layer norm and the silu gate;
* **channel-mix**: token-shifted squared-ReLU MLP with a sigmoid gate.

Every layer's WKV, over a prompt (S > 1) and for one decode token (S = 1),
goes through :func:`repro_torch.kernels.rwkv6_scan.rwkv6_scan` (the CUDA
kernel on the card, its plain version on the CPU): r/k/v/w in fp32 as
``(B, H, S, D)`` views of the ``(B, S, H, D)`` projections, y written into a
``(B, S, H, D)`` buffer (under autograd into the kernel's own buffer of
that layout, with its backward kernel behind it).  ``cfg.remat``
checkpoints each block of a forward that autograd records, as the
reference's; the block's first forward runs under
:func:`~repro_torch.kernels.rwkv6_scan.no_saved_states`, so only the
recompute of the backward writes the scan's piece states, one layer's at
a time.  The reference evaluates the same recurrence by
its chunked-parallel form for S > 1 (``wkv_chunked``) and by a per-token
scan for S = 1; the kernel computes the recurrence itself.

Parameters mirror the JAX tree with ``blocks`` a list of one dict per
layer.  Decode carries ``(shift_tm, shift_cm, wkv)`` per layer: O(1) per
token.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.rwkv6_scan import no_saved_states, rwkv6_scan
from . import attention as A
from .lm import LMConfig, _dense_init, require_ported

Params = Dict[str, Any]

LORA_TM = 32      # token-shift ddlerp adapter rank
LORA_W = 64       # decay adapter rank
N_MIX = 5         # r, k, v, w, g


def _ln_params(d: int, dtype, device) -> Params:
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


def init_block(cfg: LMConfig, dtype, device, generator) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    h = d // cfg.rwkv_head_dim

    def dense(shape, scale=None, dt=dtype):
        return _dense_init(shape, dt, device, generator, scale)

    return {
        "ln1": _ln_params(d, dtype, device),
        "ln2": _ln_params(d, dtype, device),
        "tm": {
            "mu": torch.full((N_MIX, d), 0.5, dtype=dtype, device=device),
            "mu_x": torch.full((d,), 0.5, dtype=dtype, device=device),
            "maa_w1": dense((d, N_MIX * LORA_TM), 0.01),
            "maa_w2": dense((N_MIX, LORA_TM, d), 0.01),
            "wr": dense((d, d)),
            "wk": dense((d, d)),
            "wv": dense((d, d)),
            "wg": dense((d, d)),
            "wo": dense((d, d)),
            "w0": torch.full((d,), -6.0, dtype=torch.float32, device=device),
            "w_lora1": dense((d, LORA_W), 0.01),
            "w_lora2": dense((LORA_W, d), 0.01),
            "u": dense((h, cfg.rwkv_head_dim), 0.1, torch.float32),
            "ln_x": _ln_params(d, dtype, device),
        },
        "cm": {
            "mu_k": torch.full((d,), 0.5, dtype=dtype, device=device),
            "mu_r": torch.full((d,), 0.5, dtype=dtype, device=device),
            "wk": dense((d, f)),
            "wv": dense((f, d)),
            "wr": dense((d, d)),
        },
    }


def init_params(cfg: LMConfig, device: torch.device,
                generator: Optional[torch.Generator] = None) -> Params:
    """Random parameters with the reference's shapes, dtypes and init
    scales (not its numbers).  ``device="meta"`` gives shapes only."""
    require_ported(cfg, "ssm")
    dtype = cfg.dtype
    return {
        "embed": _dense_init((cfg.vocab, cfg.d_model), dtype, device,
                             generator, 0.02),
        "blocks": [init_block(cfg, dtype, device, generator)
                   for _ in range(cfg.n_layers)],
        "final_norm": _ln_params(cfg.d_model, dtype, device),
        "head": _dense_init((cfg.d_model, cfg.vocab), dtype, device,
                            generator),
    }


# ---------------------------------------------------------------------------
# time-mix
# ---------------------------------------------------------------------------
def _shifted(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """The previous token of every position: x_prev (B, D), then x[:, :-1]."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _ddlerp(tm: Params, x: torch.Tensor,
            x_prev: torch.Tensor) -> List[torch.Tensor]:
    """Finch data-dependent token shift: (x_r, x_k, x_v, x_w, x_g)."""
    dx = x_prev - x
    xx = x + dx * tm["mu_x"]
    z = torch.tanh(xx @ tm["maa_w1"])
    z = z.reshape(z.shape[:-1] + (N_MIX, LORA_TM))
    m = torch.einsum("...nl,nld->...nd", z, tm["maa_w2"])
    mixed = x[..., None, :] + dx[..., None, :] * (tm["mu"] + m)
    return [mixed[..., i, :] for i in range(N_MIX)]


def _decay(tm: Params, x_w: torch.Tensor) -> torch.Tensor:
    """Per-channel decay in (0, 1), fp32."""
    lora = torch.tanh(x_w @ tm["w_lora1"]) @ tm["w_lora2"]
    return torch.exp(-torch.exp(tm["w0"] + lora.float()))


def time_mix(cfg: LMConfig, tm: Params, x: torch.Tensor,
             x_prev: torch.Tensor, state: torch.Tensor):
    """x: (B, S, D); x_prev: (B, D) shift carry; state: (B, H, K, V) fp32.
    Returns (out, new x_prev, new state)."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    x_r, x_k, x_v, x_w, x_g = _ddlerp(tm, x, _shifted(x, x_prev))
    r, k, v = ((xi @ tm[name]).reshape(b, s, h, hd).float()
               for xi, name in ((x_r, "wr"), (x_k, "wk"), (x_v, "wv")))
    g = F.silu(x_g @ tm["wg"])
    w = _decay(tm, x_w).reshape(b, s, h, hd)
    buf = torch.empty((b, s, h, hd), dtype=torch.float32, device=x.device)
    y, state = rwkv6_scan(*(t.transpose(1, 2) for t in (r, k, v, w)),
                          tm["u"], state, out=buf.transpose(1, 2))
    y = A.layer_norm(y.transpose(1, 2).reshape(b, s, d).to(x.dtype),
                     tm["ln_x"]["scale"], tm["ln_x"]["bias"])
    return (y * g) @ tm["wo"], x[:, -1], state


def channel_mix(cm: Params, x: torch.Tensor, x_prev: torch.Tensor):
    prev = _shifted(x, x_prev)
    x_k = x + (prev - x) * cm["mu_k"]
    x_r = x + (prev - x) * cm["mu_r"]
    k = torch.square(F.relu(x_k @ cm["wk"]))
    return torch.sigmoid(x_r @ cm["wr"]) * (k @ cm["wv"]), x[:, -1]


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------
def _zero_layer_state(cfg: LMConfig, b: int, device) -> Params:
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    return {"wkv": torch.zeros((b, d // hd, hd, hd), dtype=torch.float32,
                               device=device),
            "shift_tm": torch.zeros((b, d), dtype=cfg.dtype, device=device),
            "shift_cm": torch.zeros((b, d), dtype=cfg.dtype, device=device)}


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device: torch.device) -> Params:
    """Zero per-layer states (the size does not depend on ``max_len``) and
    the length 0."""
    require_ported(cfg, "ssm")
    return {"layers": [_zero_layer_state(cfg, batch, device)
                       for _ in range(cfg.n_layers)],
            "len": 0}


def block(cfg: LMConfig, bp: Params, x: torch.Tensor, st: Params):
    h = A.layer_norm(x, bp["ln1"]["scale"], bp["ln1"]["bias"])
    out, sh_tm, wkv = time_mix(cfg, bp["tm"], h, st["shift_tm"], st["wkv"])
    x = x + out
    h = A.layer_norm(x, bp["ln2"]["scale"], bp["ln2"]["bias"])
    out, sh_cm = channel_mix(bp["cm"], h, st["shift_cm"])
    return x + out, {"wkv": wkv, "shift_tm": sh_tm, "shift_cm": sh_cm}


def _block_hidden(cfg: LMConfig, bp: Params, x: torch.Tensor,
                  st: Params) -> torch.Tensor:
    return block(cfg, bp, x, st)[0]


def _remat_contexts():
    """A checkpointed block's forward drops what it saves, so its scan
    writes no piece states; its recompute writes them."""
    return no_saved_states(), contextlib.nullcontext()


def _run_blocks(cfg: LMConfig, params: Params, tokens: torch.Tensor,
                states: Optional[List[Params]]):
    """The blocks from the embedding, each from its state in ``states``
    (None: zero states, the full-sequence forward).  With ``cfg.remat``,
    while autograd records a full-sequence forward (grad mode on and the
    hidden state requiring grad), each block runs under
    :func:`torch.utils.checkpoint.checkpoint` (non-reentrant), as the
    reference's ``jax.checkpoint`` of its scan body: only its input is
    kept, the backward recomputes its forward, scan kernel included, and
    its new state is not returned (None); the scan's piece states are
    written by the recompute only (:func:`_remat_contexts`)."""
    embed = params["embed"]
    x = embed[tokens.to(embed.device)]
    remat = (states is None and cfg.remat and torch.is_grad_enabled()
             and x.requires_grad)
    if states is None:
        states = [_zero_layer_state(cfg, x.shape[0], x.device)] * cfg.n_layers
    new_states = []
    for bp, st in zip(params["blocks"], states):
        if remat:
            x = checkpoint(_block_hidden, cfg, bp, x, st, use_reentrant=False,
                           context_fn=_remat_contexts)
            new_states.append(None)
            continue
        x, st = block(cfg, bp, x, st)
        new_states.append(st)
    return x, new_states


def unembed(cfg: LMConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = A.layer_norm(x, params["final_norm"]["scale"],
                     params["final_norm"]["bias"])
    return (x @ params["head"]).float()


def forward(cfg: LMConfig, params: Params, batch: Dict[str, torch.Tensor],
            cache: Optional[Params] = None, last_token_only: bool = False):
    """Full-sequence forward -> fp32 logits; with ``cache`` (a prompt
    prefilled into the state, or one decode token) also the new cache."""
    require_ported(cfg, "ssm")
    tokens = batch["tokens"]
    x, states = _run_blocks(cfg, params, tokens,
                            cache["layers"] if cache is not None else None)
    if last_token_only:
        x = x[:, -1:]
    logits = unembed(cfg, params, x)
    if cache is not None:
        return logits, {"layers": states,
                        "len": cache["len"] + tokens.shape[1]}
    return logits


def forward_decode(cfg: LMConfig, params: Params, tokens: torch.Tensor,
                   cache: Params):
    """tokens (B, S) (S = 1: one decode step) -> (logits, new cache)."""
    return forward(cfg, params, {"tokens": tokens}, cache=cache)


def forward_hidden(cfg: LMConfig, params: Params,
                   batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Post-block hidden states (B, S, D): pair with :func:`unembed`."""
    require_ported(cfg, "ssm")
    return _run_blocks(cfg, params, batch["tokens"], None)[0]
