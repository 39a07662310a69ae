"""Self-contained AdamW + schedule + clipping, as ``repro/optim/adamw.py``.

Moments are fp32 whatever the parameter dtype (bf16-safe), the step an
int32 0-d tensor.  Every leaf, norms and embeddings included, takes the
decoupled weight decay, as there.  Trees are the port's parameter trees
(dicts and lists of tensors), walked in the checkpoint store's leaf order.

The update is functional, as the reference's pure pytree function is: it
returns new tensors and never writes into its inputs, so a caller that
keeps an earlier state (``runtime.TrainSupervisor``'s clean-restart
fallback) keeps it intact.  ``adamw_update(..., donate=True)`` is the
reference's jitted step with ``donate_argnums=(0, 1)``: the same loop,
its values written into the inputs' storage.  ``torch.optim.AdamW`` is not a
substitute: it keeps the moments in the parameter dtype and orders the
arithmetic differently.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from ..checkpoint.store import tree_flatten, tree_unflatten

Params = Any

# elements of a leaf that the global norm and the update take at a
# time: their fp32 temporaries stay a few such pieces, not copies of the
# largest leaf (a 1.25e9-element embedding: 5 GB each)
PIECE = 1 << 26


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
    gnorm, scale = _norm_and_scale(leaves, max_norm)
    return tree_unflatten(treedef, [(g.float() * scale).to(g.dtype)
                                    for g in leaves]), gnorm


def _norm_and_scale(leaves, max_norm: float):
    """The global norm, each leaf's fp32 squares summed PIECE elements at a
    time in order (no fp32 copy of a whole large leaf), and the clip
    scale."""
    def squares(g):
        g = g.reshape(-1)
        return sum(torch.sum(torch.square(g[i:i + PIECE].float()))
                   for i in range(0, g.numel(), PIECE))
    gnorm = torch.sqrt(sum(squares(g) for g in leaves))
    return gnorm, torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12),
                              max=1.0)


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
                 state: Dict[str, Any], donate: bool = False
                 ) -> Tuple[Params, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One clipped AdamW step -> (new params, new state, {"lr",
    "grad_norm"}).  Each leaf goes PIECE elements at a time, its gradient
    clipped a piece at a time, so the step holds no clipped copy of the
    gradients and few fp32 temporaries.  The new values go into fresh
    tensors (no input is written) or, with ``donate``, into the tensors
    of ``params`` and ``state`` (contiguous), which are returned and must
    not be read as the old state again: the step then holds no second
    state."""
    step = state["step"] + 1
    lr = cosine_warmup_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    flat_p, treedef = tree_flatten(params)
    flat_g = tree_flatten(grads)[0]
    flat_mu = tree_flatten(state["mu"])[0]
    flat_nu = tree_flatten(state["nu"])[0]
    gnorm, scale = _norm_and_scale(flat_g, cfg.grad_clip)
    if donate:
        outs = flat_p, flat_mu, flat_nu
    else:
        fresh = lambda xs: [torch.empty(x.shape, dtype=x.dtype,  # noqa: E731
                                        device=x.device) for x in xs]
        outs = fresh(flat_p), fresh(flat_mu), fresh(flat_nu)
    for p, g, mu, nu, p_out, mu_out, nu_out in zip(
            flat_p, flat_g, flat_mu, flat_nu, *outs):
        p, g, mu, nu = (x.reshape(-1) for x in (p, g, mu, nu))
        p_out, mu_out, nu_out = (x.view(-1) for x in (p_out, mu_out, nu_out))
        for i in range(0, p.numel(), PIECE):
            part = slice(i, i + PIECE)
            gf = (g[part].float() * scale).to(g.dtype).float()
            m = torch.add(cfg.b1 * mu[part], (1 - cfg.b1) * gf,
                          out=mu_out[part])
            n = torch.add(cfg.b2 * nu[part], (1 - cfg.b2) * gf * gf,
                          out=nu_out[part])
            delta = (m / b1c) / (torch.sqrt(n / b2c) + cfg.eps)
            pf = p[part].float()
            p_out[part].copy_(pf - lr * (delta + cfg.weight_decay * pf))
    new_p, new_mu, new_nu = ((params, state["mu"], state["nu"]) if donate
                             else [tree_unflatten(treedef, xs) for xs in outs])
    return new_p, {"mu": new_mu, "nu": new_nu, "step": step}, {
        "lr": lr, "grad_norm": gnorm}
