"""Parameters of the JAX reference, as numpy arrays, -> this package's.

The JAX tree stacks the per-layer ``blocks`` along a leading layer axis and
lays weights out ``(in, out)``; :func:`params_from_numpy` splits ``blocks``
into one dict per layer and keeps every layout.  A JAX bf16 array becomes
an ``ml_dtypes.bfloat16`` numpy array, which :func:`torch.from_numpy`
rejects, so such arrays pass through their uint16 bits.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .. import resolve_device
from .lm import LMConfig, Params, require_ported


def tensor_from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a)                           # writable, owned copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(cfg: LMConfig, tree: Dict[str, Any],
                      device="cuda") -> Params:
    """``tree``: the reference's parameters with numpy leaves (e.g.
    ``jax.tree.map(np.asarray, params)``)."""
    require_ported(cfg)
    dev = resolve_device(device)
    out = {k: _tree(v, lambda a: tensor_from_numpy(a, dev))
           for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [_tree(tree["blocks"],
                           lambda a, i=i: tensor_from_numpy(a[i], dev))
                     for i in range(cfg.n_layers)]
    return out
