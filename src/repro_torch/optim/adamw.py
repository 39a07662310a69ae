"""Self-contained AdamW + schedule + clipping, as ``repro/optim/adamw.py``.

Moments are fp32 whatever the parameter dtype (bf16-safe), the step an
int32 0-d tensor.  Every leaf, norms and embeddings included, takes the
decoupled weight decay, as there.  Trees are the port's parameter trees
(dicts and lists of tensors), walked in the checkpoint store's leaf order.

The update is functional, as the reference's pure pytree function is: it
returns new tensors and never writes into its inputs, so a caller that
keeps an earlier state (``runtime.TrainSupervisor``'s clean-restart
fallback) keeps it intact.  ``torch.optim.AdamW`` is not a substitute: it
keeps the moments in the parameter dtype and orders the arithmetic
differently.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from ..checkpoint.store import tree_flatten, tree_unflatten

Params = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_warmup_schedule(cfg: AdamWConfig,
                           step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine decay to
    ``min_lr_ratio * lr`` at ``total_steps``; fp32 0-d."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


@torch.no_grad()
def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    """Grads scaled by ``min(1, max_norm / max(gnorm, 1e-12))`` (each cast
    back to its dtype), and the global norm over fp32 squares."""
    leaves, treedef = tree_flatten(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return tree_unflatten(treedef, [(g.float() * scale).to(g.dtype)
                                    for g in leaves]), gnorm


def adamw_init(params: Params) -> Dict[str, Any]:
    """fp32 zero moments of every leaf, and step 0, on the params'
    device."""
    leaves, treedef = tree_flatten(params)
    zeros = lambda: tree_unflatten(treedef, [  # noqa: E731
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for p in leaves])
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves[0].device)}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Params, grads: Params,
                 state: Dict[str, Any]
                 ) -> Tuple[Params, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One clipped AdamW step -> (new params, new state, {"lr",
    "grad_norm"}); no input is written."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = cosine_warmup_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(p, g, mu, nu):
        gf = g.float()
        mu = cfg.b1 * mu + (1 - cfg.b1) * gf
        nu = cfg.b2 * nu + (1 - cfg.b2) * gf * gf
        mhat = mu / b1c
        nhat = nu / b2c
        delta = mhat / (torch.sqrt(nhat) + cfg.eps)
        pf = p.float()
        pf = pf - lr * (delta + cfg.weight_decay * pf)
        return pf.to(p.dtype), mu, nu

    flat_p, treedef = tree_flatten(params)
    flat_g = tree_flatten(grads)[0]
    flat_mu = tree_flatten(state["mu"])[0]
    flat_nu = tree_flatten(state["nu"])[0]
    outs = [upd(p, g, m, n) for p, g, m, n
            in zip(flat_p, flat_g, flat_mu, flat_nu)]
    new_p = tree_unflatten(treedef, [o[0] for o in outs])
    new_mu = tree_unflatten(treedef, [o[1] for o in outs])
    new_nu = tree_unflatten(treedef, [o[2] for o in outs])
    metrics = {"lr": lr, "grad_norm": gnorm}
    return new_p, {"mu": new_mu, "nu": new_nu, "step": step}, metrics
