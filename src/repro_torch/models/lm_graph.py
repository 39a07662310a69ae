"""Lower an LM architecture to a :class:`LayerGraph` for the segmentation
planner, as ``repro/models/lm_graph.py`` does for the ported families.

Per-node parameter counts are exact: they come from the real initializer
(:func:`repro_torch.models.api.init`) run on the ``meta`` device (shapes,
no allocation), so the planner balances the same bytes the runtime holds.
MACs use the per-family analytical estimators.  The graph equals the
reference's node by node, so every plan over it is the reference's plan.

Depth structure: ``embed -> block nodes -> final_norm -> head``; the block
nodes are ``block_i`` (dense, ssm) or ``block_i_rec`` / ``block_i_attn``
(hybrid).  whisper (encdec): ``encoder_input -> enc_0 .. enc_{E-1}``, then
``embed -> dec_0 .. dec_{L-1} -> head``, every ``dec_i`` also fed by the
last encoder layer (its cross-attention edge), so the longest-path depth
rule (paper §6.1.1) places every decoder layer after the whole encoder.
"""
from __future__ import annotations

import torch

from ..core.costs import TransformerBlockCost
from ..core.graph import LayerGraph
from . import api
from .lm import LMConfig
from .rglru import n_super_and_tail


def _block_cost(cfg: LMConfig) -> TransformerBlockCost:
    return TransformerBlockCost(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_ff=cfg.d_ff, head_dim=cfg.hd, qkv_bias=cfg.qkv_bias,
        n_experts=cfg.n_experts, top_k=cfg.top_k,
        ffn_gated=cfg.mlp_kind in ("swiglu", "geglu"))


def _rwkv_macs(cfg: LMConfig, seq: int) -> int:
    d, f = cfg.d_model, cfg.d_ff
    tm = 5 * d * d + d * (cfg.rwkv_head_dim * 2)       # proj + wkv per token
    cm = 2 * d * f + d * d
    return seq * (tm + cm)


def _rec_macs(cfg: LMConfig, seq: int) -> int:
    d = cfg.d_model
    temporal = 3 * d * d + cfg.conv_width * d          # wx, wgate, wo + conv
    mlp = 3 * d * cfg.d_ff
    return seq * (temporal + mlp)


def lm_layer_graph(cfg: LMConfig, seq_len: int = 4096,
                   act_bytes_per_elt: int = 2) -> LayerGraph:
    """Build the segmentation view of an LM arch (per single sequence)."""
    g = LayerGraph(cfg.name)
    shapes = api.init(cfg, torch.device("meta"))
    act = seq_len * cfg.d_model * act_bytes_per_elt
    w_bytes = 2  # bf16 weights

    if cfg.family == "encdec":
        return _encdec_graph(g, cfg, shapes, seq_len, act_bytes_per_elt,
                             w_bytes)

    embed_p = api.tree_size(shapes["embed"])
    g.add_layer("embed", params=embed_p, macs=seq_len * cfg.d_model,
                out_bytes=act, weight_bytes=embed_p * w_bytes, kind="embed")
    prev = "embed"

    def add_block(name, params, macs, kind):
        nonlocal prev
        g.add_layer(name, params=params, macs=macs, out_bytes=act,
                    inputs=[prev], weight_bytes=params * w_bytes, kind=kind)
        prev = name

    if cfg.family == "hybrid":
        n_super, tail = n_super_and_tail(cfg.n_layers, cfg.attn_every)
        per_super = api.tree_size(shapes["super"]) // n_super
        rec_p = api.tree_size(shapes["super"][0]["rec1"])
        attn_p = per_super - 2 * rec_p
        attn_macs = _block_cost(cfg).block_macs(
            seq_len, min(seq_len, cfg.local_window))
        rec_macs = _rec_macs(cfg, seq_len)
        li = 0
        for _ in range(n_super):
            for kind, p, m in (("rec", rec_p, rec_macs),
                               ("rec", rec_p, rec_macs),
                               ("attn", attn_p, attn_macs)):
                add_block(f"block_{li}_{kind}", p, m, f"{kind}_block")
                li += 1
        if tail:
            tail_p = api.tree_size(shapes["tail"]) // tail
            for _ in range(tail):
                add_block(f"block_{li}_rec", tail_p, rec_macs, "rec_block")
                li += 1
    else:
        per_block = api.tree_size(shapes["blocks"]) // cfg.n_layers
        macs = (_rwkv_macs(cfg, seq_len) if cfg.family == "ssm"
                else _block_cost(cfg).block_macs(seq_len, seq_len))
        for i in range(cfg.n_layers):
            add_block(f"block_{i}", per_block, macs, "block")

    norm_p = api.tree_size(shapes["final_norm"])
    g.add_layer("final_norm", params=norm_p, macs=0, out_bytes=act,
                inputs=[prev], weight_bytes=norm_p * w_bytes, kind="norm")
    head_p = api.tree_size(shapes["head"]) if "head" in shapes else 0
    g.add_layer("head", params=head_p, macs=seq_len * cfg.d_model * cfg.vocab,
                out_bytes=0, inputs=["final_norm"],
                weight_bytes=head_p * w_bytes, kind="head")
    return g


def _encdec_graph(g: LayerGraph, cfg: LMConfig, shapes, seq_len: int,
                  act_bytes_per_elt: int, w_bytes: int) -> LayerGraph:
    """whisper's DAG (module docstring); the tied unembedding's weight
    bytes live with ``embed``, its MACs and both final norms with
    ``head``."""
    act = seq_len * cfg.d_model * act_bytes_per_elt
    bc = _block_cost(cfg)
    frame_act = cfg.n_frames * cfg.d_model * act_bytes_per_elt
    g.add_layer("encoder_input", params=0, macs=0, out_bytes=frame_act,
                kind="stub")
    prev = "encoder_input"
    per_enc = api.tree_size(shapes["enc"]) // cfg.n_enc_layers
    enc_macs = bc.block_macs(cfg.n_frames, cfg.n_frames)
    for i in range(cfg.n_enc_layers):
        g.add_layer(f"enc_{i}", params=per_enc, macs=enc_macs,
                    out_bytes=frame_act, inputs=[prev],
                    weight_bytes=per_enc * w_bytes, kind="enc_block")
        prev = f"enc_{i}"
    enc_out = prev
    embed_p = api.tree_size(shapes["embed"])
    g.add_layer("embed", params=embed_p, macs=seq_len * cfg.d_model,
                out_bytes=act, weight_bytes=embed_p * w_bytes, kind="embed")
    prev = "embed"
    per_dec = api.tree_size(shapes["dec"]) // cfg.n_layers
    dec_macs = (bc.block_macs(seq_len, seq_len)
                + 2 * seq_len * cfg.n_frames * cfg.n_heads * cfg.hd)
    for i in range(cfg.n_layers):
        g.add_layer(f"dec_{i}", params=per_dec, macs=dec_macs,
                    out_bytes=act, inputs=[prev, enc_out],
                    weight_bytes=per_dec * w_bytes, kind="dec_block")
        prev = f"dec_{i}"
    ln = api.tree_size(shapes["dec_ln"]) + api.tree_size(shapes["enc_ln"])
    g.add_layer("head", params=ln, macs=seq_len * cfg.d_model * cfg.vocab,
                out_bytes=0, inputs=[prev], weight_bytes=ln * w_bytes,
                kind="head")
    return g
