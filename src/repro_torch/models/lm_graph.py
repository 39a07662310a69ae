"""Lower an LM architecture to a :class:`LayerGraph` for the segmentation
planner, as ``repro/models/lm_graph.py`` does for the dense family.

Per-node parameter counts are exact: they come from the real initializer
run on the ``meta`` device (shapes, no allocation), so the planner
balances the same bytes the runtime holds.  MACs use the analytical
per-block estimator.  The graph equals the reference's node by node, so
every plan over it is the reference's plan.

Depth structure: ``embed -> block_0 .. block_{L-1} -> final_norm -> head``.
"""
from __future__ import annotations

import math

import torch

from ..core.costs import TransformerBlockCost
from ..core.graph import LayerGraph
from .lm import LMConfig, init_params


def _tree_size(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_size(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_tree_size(v) for v in tree)
    return math.prod(tree.shape)


def _block_cost(cfg: LMConfig) -> TransformerBlockCost:
    return TransformerBlockCost(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_ff=cfg.d_ff, head_dim=cfg.hd, qkv_bias=cfg.qkv_bias,
        n_experts=cfg.n_experts, top_k=cfg.top_k,
        ffn_gated=cfg.mlp_kind in ("swiglu", "geglu"))


def lm_layer_graph(cfg: LMConfig, seq_len: int = 4096,
                   act_bytes_per_elt: int = 2) -> LayerGraph:
    """Build the segmentation view of an LM arch (per single sequence)."""
    g = LayerGraph(cfg.name)
    shapes = init_params(cfg, torch.device("meta"))
    act = seq_len * cfg.d_model * act_bytes_per_elt
    w_bytes = 2  # bf16 weights

    embed_p = _tree_size(shapes["embed"])
    g.add_layer("embed", params=embed_p, macs=seq_len * cfg.d_model,
                out_bytes=act, weight_bytes=embed_p * w_bytes, kind="embed")
    prev = "embed"
    per_block = _tree_size(shapes["blocks"]) // cfg.n_layers
    macs = _block_cost(cfg).block_macs(seq_len, seq_len)
    for i in range(cfg.n_layers):
        g.add_layer(f"block_{i}", params=per_block, macs=macs,
                    out_bytes=act, inputs=[prev],
                    weight_bytes=per_block * w_bytes, kind="block")
        prev = f"block_{i}"

    norm_p = _tree_size(shapes["final_norm"])
    g.add_layer("final_norm", params=norm_p, macs=0, out_bytes=act,
                inputs=[prev], weight_bytes=norm_p * w_bytes, kind="norm")
    head_p = _tree_size(shapes["head"]) if "head" in shapes else 0
    g.add_layer("head", params=head_p, macs=seq_len * cfg.d_model * cfg.vocab,
                out_bytes=0, inputs=["final_norm"],
                weight_bytes=head_p * w_bytes, kind="head")
    return g
