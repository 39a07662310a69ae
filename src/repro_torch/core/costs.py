"""Per-layer cost helpers shared by the CNN and LM graph builders, plus the
single bytes-accounting model every memory consumer prices with.

MAC conventions follow the paper (§3): a conv layer's MACs = #params × output
spatial dims (stride-1, zero padding keeps W×H constant); a dense layer's
MACs = #params.  Activation byte counts assume int8 for the quantized CNN
path (1 B/elt) and bf16 (2 B/elt) for LM archs.

The memory helpers (:func:`weight_capacity_bytes`,
:func:`greedy_layer_split`) are the paper's §4.2 compiler-report model in
one place: the :class:`~repro_torch.core.cost_engine.SegmentCostEngine`, the
naive :class:`~repro_torch.core.edge_tpu_model.EdgeTPUModel` paths, and the
refinement reporter all call them, so device/host byte accounting cannot
drift between the planner, the refiner, and the CostSource layer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple


# ---------------------------------------------------------------------------
# bytes accounting (paper §4.2: the Edge TPU compiler's memory report)
# ---------------------------------------------------------------------------
def weight_capacity_bytes(onchip_bytes: int, fixed_reserve: int,
                          act_reserve_factor: float,
                          max_activation: int) -> int:
    """Weight capacity of one device: on-chip memory minus the fixed
    (instructions) reserve minus the activation reserve — the exact
    expression (and float evaluation order) every capacity query uses."""
    return int(onchip_bytes - fixed_reserve
               - act_reserve_factor * max_activation)


def greedy_layer_split(layer_bytes: Sequence[int], capacity: int,
                       device0: int = 0) -> Tuple[int, int]:
    """(device_bytes, host_bytes) of the paper's greedy whole-layer
    placement: layers are placed in order while they fit; a rejected layer
    goes to host, but smaller later layers may still fit (`§4.2: 'the
    neural layer is the minimal storage unit'`).  ``device0`` seeds the
    device counter — the cost engine's binary-searched fast path hands the
    tail scan its already-placed prefix."""
    device = device0
    host = 0
    for b in layer_bytes:
        if device + b <= capacity:
            device += b
        else:
            host += b
    return device, host


def greedy_layer_placement(names: Sequence[str],
                           layer_bytes: Sequence[int], capacity: int
                           ) -> Tuple[int, int, Dict[str, str]]:
    """Full (device, host, {layer: "device"|"host"}) greedy placement —
    the per-layer report variant of :func:`greedy_layer_split`."""
    device = 0
    host = 0
    placement: Dict[str, str] = {}
    for n, b in zip(names, layer_bytes):
        if device + b <= capacity:
            device += b
            placement[n] = "device"
        else:
            host += b
            placement[n] = "host"
    return device, host, placement


def conv2d_params(cin: int, cout: int, kh: int, kw: int, bias: bool = True) -> int:
    return cin * cout * kh * kw + (cout if bias else 0)


def conv2d_macs(cin: int, cout: int, kh: int, kw: int,
                out_h: int, out_w: int) -> int:
    return cin * cout * kh * kw * out_h * out_w


def dw_conv2d_params(c: int, kh: int, kw: int, bias: bool = True) -> int:
    return c * kh * kw + (c if bias else 0)


def dw_conv2d_macs(c: int, kh: int, kw: int, out_h: int, out_w: int) -> int:
    return c * kh * kw * out_h * out_w


def dense_params(fin: int, fout: int, bias: bool = True) -> int:
    return fin * fout + (fout if bias else 0)


def dense_macs(fin: int, fout: int) -> int:
    return fin * fout


def conv_out_hw(h: int, w: int, kh: int, kw: int, stride: int,
                padding: str = "same") -> Tuple[int, int]:
    if padding == "same":
        return math.ceil(h / stride), math.ceil(w / stride)
    if padding == "valid":
        return (h - kh) // stride + 1, (w - kw) // stride + 1
    raise ValueError(padding)


@dataclasses.dataclass(frozen=True)
class TransformerBlockCost:
    """Parameter/MAC breakdown of one decoder block (per token)."""

    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    head_dim: int
    qkv_bias: bool = False
    n_experts: int = 0       # 0 = dense FFN
    top_k: int = 0
    ffn_gated: bool = True   # SwiGLU: 3 matrices; plain MLP: 2

    @property
    def attn_params(self) -> int:
        hd = self.head_dim
        q = self.d_model * self.n_heads * hd
        kv = 2 * self.d_model * self.n_kv_heads * hd
        o = self.n_heads * hd * self.d_model
        b = (self.n_heads * hd + 2 * self.n_kv_heads * hd) if self.qkv_bias else 0
        return q + kv + o + b

    @property
    def ffn_params_per_expert(self) -> int:
        m = 3 if self.ffn_gated else 2
        return m * self.d_model * self.d_ff

    @property
    def ffn_params(self) -> int:
        n = max(1, self.n_experts)
        router = self.d_model * self.n_experts if self.n_experts else 0
        return n * self.ffn_params_per_expert + router

    @property
    def block_params(self) -> int:
        norms = 2 * self.d_model
        return self.attn_params + self.ffn_params + norms

    def block_macs(self, seq_len: int, kv_len: int) -> int:
        """MACs per sequence (projections + attention scores + FFN)."""
        proj = seq_len * self.attn_params
        scores = 2 * seq_len * kv_len * self.n_heads * self.head_dim
        active = max(1, self.top_k if self.n_experts else 1)
        ffn = seq_len * active * self.ffn_params_per_expert
        router = seq_len * self.d_model * self.n_experts if self.n_experts else 0
        return proj + scores + ffn + router
