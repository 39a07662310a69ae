"""Parameters of the JAX reference, as numpy arrays, -> this package's.

The JAX tree stacks repeated layers along a leading axis (``blocks`` of
the dense and ssm families; ``super`` super-blocks and ``tail`` rec blocks
of the hybrid family) and lays weights out ``(in, out)``;
:func:`params_from_numpy` splits each stack into a list of one dict per
layer and keeps every layout.  A JAX bf16 array becomes an
``ml_dtypes.bfloat16`` numpy array, which :func:`torch.from_numpy` rejects,
so such arrays pass through their uint16 bits.
:func:`cnn_params_from_numpy` maps the CNN zoo's per-node dicts.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .. import resolve_device
from .lm import LMConfig, Params, require_ported
from .rglru import n_super_and_tail


def tensor_from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a)                           # writable, owned copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _stacks(cfg: LMConfig) -> Dict[str, int]:
    """Stacked subtrees of the family's JAX tree -> their layer counts."""
    if cfg.family == "hybrid":
        n_super, tail = n_super_and_tail(cfg.n_layers, cfg.attn_every)
        return {"super": n_super, "tail": tail}
    return {"blocks": cfg.n_layers}


def params_from_numpy(cfg: LMConfig, tree: Dict[str, Any],
                      device="cuda") -> Params:
    """``tree``: the reference's parameters with numpy leaves (e.g.
    ``jax.tree.map(np.asarray, params)``)."""
    require_ported(cfg)
    dev = resolve_device(device)
    stacks = _stacks(cfg)
    out = {}
    for key, sub in tree.items():
        if key in stacks:
            out[key] = [_tree(sub, lambda a, i=i: tensor_from_numpy(a[i], dev))
                        for i in range(stacks[key])]
        else:
            out[key] = _tree(sub, lambda a: tensor_from_numpy(a, dev))
    return out


def cnn_params_from_numpy(tree: Dict[str, Dict[str, Any]],
                          device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """The reference's CNN parameters (``{node: {"w", "b", "gamma", ...}}``
    of numpy arrays, e.g. ``jax.tree.map(np.asarray, model.init(key))``) ->
    :mod:`repro_torch.models.layers`'s: conv weights HWIO -> OIHW held
    ``channels_last``; dense weights keep their ``(fin, units)`` layout;
    biases and BN tensors stay as they are."""
    dev = resolve_device(device)
    out = {}
    for node, sub in tree.items():
        p = {}
        for key, a in sub.items():
            t = tensor_from_numpy(a, dev)
            if key == "w" and t.dim() == 4:
                t = t.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
            p[key] = t
        out[node] = p
    return out
