"""Step builders, as ``repro/launch/steps.py``: train_step / prefill_step /
decode_step per architecture.

They are plain functions over the port's parameter trees; the train step
differentiates with autograd (the attention layers through the
flash-attention kernel's backward) and updates with the functional AdamW
of :mod:`repro_torch.optim`.  The dry-run's ``train_state_shapes`` and
``cache_shapes`` (``jax.eval_shape`` there) build their trees on the
``meta`` device: shapes and dtypes, no storage.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..checkpoint.store import tree_flatten, tree_unflatten
from ..models import api
from ..models.lm import LMConfig
from ..optim import AdamWConfig, adamw_init, adamw_update

Params = Any


def chunked_lm_loss(cfg: LMConfig, params: Params, hidden: torch.Tensor,
                    labels: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Cross-entropy without materializing (B, S, V) logits: the sequence
    in chunks, unembedding one chunk at a time; while autograd records,
    each chunk runs under :func:`torch.utils.checkpoint.checkpoint`, so the
    backward recomputes a chunk's logits instead of saving them."""
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    labels = labels.to(hidden.device)

    def chunk_nll(h, lab):
        logits = api.unembed(cfg, params, h)            # (B, chunk, V) fp32
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab.long()[..., None])[..., 0]
        return torch.sum(logz - gold)

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(s // chunk):
        h = hidden[:, c * chunk:(c + 1) * chunk]
        lab = labels[:, c * chunk:(c + 1) * chunk]
        if torch.is_grad_enabled():
            total = total + checkpoint(chunk_nll, h, lab, use_reentrant=False)
        else:
            total = total + chunk_nll(h, lab)
    return total / (b * s)


def loss_and_grads(cfg: LMConfig, params: Params,
                   batch: Dict[str, torch.Tensor], loss_chunk: int = 512
                   ) -> Tuple[torch.Tensor, Params]:
    """The chunked loss of ``api.forward_hidden`` on ``batch`` and its
    gradient in every parameter (a tree like ``params``; a parameter the
    loss does not reach gets zeros, as ``jax.grad`` gives).  ``params`` is
    not written."""
    leaves, treedef = tree_flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    p = tree_unflatten(treedef, live)
    with torch.enable_grad():
        hidden = api.forward_hidden(cfg, p, batch)
        loss = chunked_lm_loss(cfg, p, hidden, batch["labels"],
                               chunk=loss_chunk)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), tree_unflatten(treedef, [
        torch.zeros_like(w) if g is None else g
        for w, g in zip(leaves, grads)])


def make_train_step(cfg: LMConfig, opt_cfg: AdamWConfig,
                    loss_chunk: int = 512, donate: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: :func:`loss_and_grads`, then one AdamW update; ``metrics``
    holds ``loss``, ``lr`` and ``grad_norm`` (0-d tensors).  The inputs
    are not written, unless ``donate``: then the update writes the same
    values into ``params`` and ``opt_state`` (``adamw_update(...,
    donate=True)``, the reference's ``donate_argnums=(0, 1)``)."""
    def train_step(params: Params, opt_state: Params,
                   batch: Dict[str, torch.Tensor]):
        loss, grads = loss_and_grads(cfg, params, batch, loss_chunk)
        params, opt_state, metrics = adamw_update(opt_cfg, params, grads,
                                                  opt_state, donate)
        metrics = dict(metrics, loss=loss)
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: LMConfig):
    def prefill_step(params: Params, batch: Dict[str, torch.Tensor]):
        # unembed only the last position: avoids the (B, S, V) logits buffer
        logits = api.forward(cfg, params, batch, last_token_only=True)
        return logits[:, -1, :]            # next-token logits (B, V)

    return prefill_step


def make_decode_step(cfg: LMConfig):
    def decode_step(params: Params, cache: Params, tokens: torch.Tensor):
        logits, cache = api.decode(cfg, params, tokens, cache)
        return logits[:, -1, :], cache

    return decode_step


def init_train_state(cfg: LMConfig, device="cuda",
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[Params, Params]:
    """Random parameters on ``device`` from ``generator`` (which must live
    there; None: torch's default generator of the device) and their AdamW
    state."""
    params = api.init(cfg, resolve_device(device), generator)
    return params, adamw_init(params)


def train_state_shapes(cfg: LMConfig) -> Tuple[Params, Params]:
    """The parameters and AdamW state of ``cfg`` on the ``meta`` device
    (no allocation), for the dry-run."""
    params = api.init(cfg, "meta")
    return params, adamw_init(params)


def donate_update(cfg: LMConfig, device_bytes: int) -> bool:
    """Whether a train step of ``cfg`` on a card of ``device_bytes`` must
    write its update into the state (``make_train_step(donate=True)``):
    only where the functional update's new parameters and moments do not
    fit beside the old ones and the gradients, i.e. where twice
    ``train_state_shapes``'s bytes plus the parameters' exceed the card."""
    params, state = train_state_shapes(cfg)
    nbytes = lambda tree: sum(  # noqa: E731
        x.numel() * x.element_size() for x in tree_flatten(tree)[0])
    return 2 * (nbytes(params) + nbytes(state)) + nbytes(params) > device_bytes


def cache_shapes(cfg: LMConfig, batch: int, max_len: int) -> Params:
    """``api.init_cache`` on the ``meta`` device; its length, a Python int
    in a live cache, as the reference's int32 0-d leaf."""
    cache = api.init_cache(cfg, batch, max_len, torch.device("meta"))
    return {**cache, "len": torch.zeros((), dtype=torch.int32,
                                        device="meta")}
