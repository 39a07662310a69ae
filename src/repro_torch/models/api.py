"""Family-dispatch API, as ``repro/models/api.py``: one surface for every
family (dense, moe and vlm = ``lm``, ssm = rwkv6, hybrid = recurrentgemma,
encdec = whisper).

    init(cfg, device, generator)               -> params
    forward(cfg, params, batch)                -> fp32 logits (prefill)
    forward_hidden / unembed                   -> hidden states / logits
    init_cache(cfg, batch, max_len, device)    -> decode cache
    decode(cfg, params, tokens, cache)         -> (logits, cache)
    prefill(cfg, params, batch, cache)         -> (logits, cache)
    param_count(cfg), active_param_count(cfg)  -> exact parameter counts

``prefill`` (the attention families; not in the reference, whose decode
takes one token a step) puts a prompt batch into an empty KV cache in one
forward.

encdec: ``batch`` holds ``frames`` (B, n_frames, d_model) stub embeddings
and ``tokens``; ``init_cache`` gives the reference's all-zero memory K/V,
so a real decode loop builds its cache from the encoder's memory with
:func:`repro_torch.models.whisper.init_cache` (``memory=whisper.encode(
...), params=...``) and steps it through :func:`decode`.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from . import lm, rglru, rwkv6, whisper
from .lm import LMConfig

Params = Dict[str, Any]

_MODULES = {"dense": lm, "moe": lm, "vlm": lm, "ssm": rwkv6,
            "hybrid": rglru, "encdec": whisper}


def _module(cfg: LMConfig):
    lm.require_ported(cfg)
    return _MODULES[cfg.family]


def init(cfg: LMConfig, device, generator: Optional[torch.Generator] = None
         ) -> Params:
    """Random parameters on ``device`` (``"meta"``: shapes only) drawn
    from ``generator``, which must live on ``device``."""
    cfg.validate()
    return _module(cfg).init_params(cfg, torch.device(device), generator)


def forward(cfg: LMConfig, params: Params, batch: Dict[str, torch.Tensor],
            last_token_only: bool = False) -> torch.Tensor:
    return _module(cfg).forward(cfg, params, batch,
                                last_token_only=last_token_only)


def forward_hidden(cfg: LMConfig, params: Params,
                   batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Post-block hidden states: pair with :func:`unembed`."""
    return _module(cfg).forward_hidden(cfg, params, batch)


def unembed(cfg: LMConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    return _module(cfg).unembed(cfg, params, x)


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device: torch.device) -> Params:
    return _module(cfg).init_cache(cfg, batch, max_len, device)


def decode(cfg: LMConfig, params: Params, tokens: torch.Tensor,
           cache: Params) -> Tuple[torch.Tensor, Params]:
    """One decode step (tokens (B, 1)); the ssm family also takes a whole
    prompt (B, S) into its state, as the reference's ``forward(cache=)``."""
    return _module(cfg).forward_decode(cfg, params, tokens, cache)


def prefill(cfg: LMConfig, params: Params, batch: Dict[str, torch.Tensor],
            cache: Params, last_token_only: bool = False
            ) -> Tuple[torch.Tensor, Params]:
    """A prompt batch (as :func:`forward`'s, vlm embeds and positions
    included) into an empty cache of the attention families
    (:func:`repro_torch.models.lm.prefill`); decode steps continue after
    it.  The ssm family takes a prompt through :func:`decode`."""
    if _module(cfg) is not lm:
        raise ValueError(f"{cfg.name}: prefill fills the KV cache of the "
                         f"attention families {lm.ATTN_FAMILIES}, not "
                         f"family {cfg.family!r}")
    return lm.prefill(cfg, params, batch, cache, last_token_only)


def tree_size(tree) -> int:
    """Elements in a parameter tree of dicts, lists and tensors."""
    if isinstance(tree, dict):
        return sum(tree_size(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_size(v) for v in tree)
    return math.prod(tree.shape)


def param_count(cfg: LMConfig) -> int:
    """Exact parameter count from the initializer on the ``meta`` device
    (no allocation)."""
    return tree_size(init(cfg, torch.device("meta")))


def active_param_count(cfg: LMConfig) -> int:
    """Parameters a token uses (moe: only top_k of the experts count)."""
    total = param_count(cfg)
    if cfg.family != "moe":
        return total
    expert_params = 3 * cfg.d_model * cfg.d_ff
    inactive = cfg.n_layers * (cfg.n_experts - cfg.top_k) * expert_params
    return total - inactive
