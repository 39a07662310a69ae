"""Per-token decode costing: the second economy on the planner's seam.

Prefill/batch costing (the paper's regime) prices a depth level by its
MACs over the whole sequence and its static weight bytes.  Steady-state
decode prices the same level very differently:

* **compute** — one token per sequence per step: the level's weight matrix
  is touched once per token (``~params`` MACs) plus the attention
  read of the live context (``2 * context * n_heads * head_dim``);
* **state** — the bytes a level pins on-device *per in-flight sequence*:
  full KV cache ``2 * context * n_kv_heads * head_dim * itemsize`` for
  dense/MoE/VLM attention, window-clamped KV for hybrid local-attention
  layers, self+cross KV for enc-dec decoder layers, and **O(1) recurrent
  state** for rwkv6 (wkv matrix + channel shifts) and rglru (conv tail +
  hidden) blocks — these do not grow with context at all, which is
  exactly why a recurrent stage can hold far more concurrent sequences;
* MoE compute only touches the ``top_k`` active experts per token, so the
  inactive expert weights count toward memory but not decode MACs.

:class:`DecodeCostSource` materializes this regime through the existing
:class:`~repro_torch.core.cost_engine.SegmentCostEngine` measured-mode seam
(per-depth ``time_s`` at the operating point's concurrency) plus the new
``state_bytes`` axis the engine prefix-sums for O(1)
``segment_state_bytes`` queries.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from ..core.edge_tpu_model import EdgeTPUSpec
from ..core.graph import LayerGraph
from ..models.lm import LMConfig
from ..profiling.sources import CostSource, DepthCosts

ACT_BYTES = 2          # bf16 activations between decode stages


def _itemsize(dtype: torch.dtype) -> int:
    """Bytes per element of a config's :class:`torch.dtype` (4 for the
    fp32 smoke config, 2 for bf16), as the reference's numpy itemsize."""
    return dtype.itemsize


@dataclasses.dataclass(frozen=True)
class DecodeOperatingPoint:
    """The (concurrency, context) point a decode plan is sized for.

    ``concurrency`` — sequences decoding together in steady state (the
    running batch); ``max_context`` — the per-sequence KV budget each
    attention layer must hold (prompt + generated tokens)."""

    concurrency: int = 4
    max_context: int = 256

    def __post_init__(self):
        if self.concurrency < 1:
            raise ValueError(f"concurrency must be >= 1, "
                             f"got {self.concurrency}")
        if self.max_context < 1:
            raise ValueError(f"max_context must be >= 1, "
                             f"got {self.max_context}")


def _node_token_costs(cfg: LMConfig, node, point: DecodeOperatingPoint
                      ) -> Tuple[int, int]:
    """(per-token MACs, per-sequence state bytes) of one graph node in the
    decode regime."""
    kind = node.kind
    d = cfg.d_model
    ctx = point.max_context
    kv_item = _itemsize(cfg.dtype)
    kv_row = 2 * cfg.n_kv_heads * cfg.hd * kv_item     # K+V bytes per pos
    attn_read = 2 * cfg.n_heads * cfg.hd               # QK^T + PV per pos

    if kind in ("stub", "enc_block"):
        # encoder work happens once at prefill; in steady-state decode an
        # encoder level does no per-token compute and pins no state
        return 0, 0
    if kind in ("embed", "norm"):
        return d, 0
    if kind == "head":
        return d * cfg.vocab, 0
    if kind == "rec_block":
        # rglru temporal block: O(1) state (conv tail in cfg.dtype +
        # fp32 hidden), linear per-token compute
        state = ((cfg.conv_width - 1) * d * _itemsize(cfg.dtype)
                 + d * 4)
        return node.params, state
    if kind == "attn_block":
        # hybrid local attention: the ring buffer clamps KV to the window
        w = min(ctx, cfg.local_window or ctx)
        return node.params + w * attn_read, w * kv_row
    if kind == "dec_block":
        # enc-dec decoder: causal self-KV over the context plus the fixed
        # cross-attention KV over the encoded frames
        span = ctx + cfg.n_frames
        return node.params + span * attn_read, span * kv_row
    if kind == "block":
        if cfg.family == "ssm":
            # rwkv6: wkv state matrix (fp32) + token/channel shifts; no
            # context term at all — the recurrent families' O(1) promise
            heads = d // cfg.rwkv_head_dim
            state = (heads * cfg.rwkv_head_dim * cfg.rwkv_head_dim * 4
                     + 2 * d * _itemsize(cfg.dtype))
            return node.params, state
        macs = node.params
        if cfg.family == "moe":
            # only top_k experts run per token; wg/wu/wd per expert
            inactive = ((cfg.n_experts - cfg.top_k)
                        * 3 * d * cfg.d_ff)
            macs = max(d, node.params - inactive)
        return macs + ctx * attn_read, ctx * kv_row
    raise ValueError(f"decode costing: unknown node kind {kind!r} "
                     f"({node.name})")


def decode_depth_costs(cfg: LMConfig, graph: LayerGraph,
                       point: DecodeOperatingPoint
                       ) -> Tuple[List[int], List[int]]:
    """Per-depth (per-token MACs, per-sequence state bytes) aligned with
    ``graph.levels()`` (levels with several nodes — the enc-dec DAG —
    sum their members)."""
    nodes = graph.nodes
    macs, state = [], []
    for lvl in graph.levels():
        m = s = 0
        for name in lvl:
            nm, ns = _node_token_costs(cfg, nodes[name], point)
            m += nm
            s += ns
        macs.append(m)
        state.append(s)
    return macs, state


class DecodeCostSource(CostSource):
    """Price a graph at a decode operating point.

    Rides the engine's measured-mode seam: ``time_s[d]`` is the weight
    fill plus ``concurrency`` tokens of decode compute for depth ``d``,
    so ``segment_time`` models one decode *step* of the whole running
    batch (the quantity whose max over stages paces tokens/s).
    ``state_bytes`` feeds ``segment_state_bytes`` — per sequence, so the
    placement cap multiplies by concurrency explicitly."""

    def __init__(self, cfg: LMConfig, point: DecodeOperatingPoint):
        self.cfg = cfg
        self.point = point
        self.name = (f"decode(c={point.concurrency},"
                     f"ctx={point.max_context})")

    def materialize(self, graph: LayerGraph, spec: EdgeTPUSpec
                    ) -> DepthCosts:
        spec = spec or EdgeTPUSpec()
        token_macs, state = decode_depth_costs(self.cfg, graph, self.point)
        n = self.point.concurrency
        weight_bytes = graph.bytes_per_depth()
        wl_rate = spec.weight_load_gbps * 1e9
        mac_rate = spec.macs_per_s
        wloads = [b / wl_rate for b in weight_bytes]
        times = [w + n * m / mac_rate
                 for w, m in zip(wloads, token_macs)]
        # one token's hidden state per in-flight sequence crosses a cut
        depth = len(token_macs)
        step_act = n * self.cfg.d_model * ACT_BYTES
        cut = [step_act] * depth
        if depth:
            cut[-1] = 0
        return DepthCosts(
            params=graph.params_per_depth(),
            macs=[n * m for m in token_macs],
            weight_bytes=weight_bytes, cut_bytes=cut,
            time_s=times, weight_load_s=wloads,
            state_bytes=state)

    def describe(self) -> str:
        return f"{self.name} on {self.cfg.name}"
