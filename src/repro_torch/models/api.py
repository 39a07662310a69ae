"""Family-dispatch API, as ``repro/models/api.py``: one surface for the
ported families (dense, ssm = rwkv6, hybrid = recurrentgemma).

    init(cfg, device, generator)               -> params
    forward(cfg, params, batch)                -> fp32 logits (prefill)
    forward_hidden / unembed                   -> hidden states / logits
    init_cache(cfg, batch, max_len, device)    -> decode cache
    decode(cfg, params, tokens, cache)         -> (logits, cache)
    param_count(cfg)                           -> exact parameter count

The moe and vlm families (the LM-families slice) and encdec (the
encoder-decoder slice) raise :class:`NotImplementedError`.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from . import lm, rglru, rwkv6
from .lm import LMConfig

Params = Dict[str, Any]

_MODULES = {"dense": lm, "ssm": rwkv6, "hybrid": rglru}


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
