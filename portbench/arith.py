"""The benchmark's own FLOP and byte counts and the chip's peaks.

Frozen here so that a change to the program cannot move the yardstick:
``attention_pairs`` and ``attention_cost`` are copies of the port's
``kernels/flash_attention.py`` functions of those names (the CPU tests hold
them equal), the convolution and LM counts follow from the shapes alone.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def peaks(kind: str = "NVIDIA H100 80GB HBM3") -> Dict[str, float]:
    """The data sheet's peaks of the card named ``kind`` (the SXM part's
    dense rates at 700 W)."""
    table = json.loads(PEAKS_FILE.read_text())
    for name, row in table["cards"].items():
        if name in kind or kind in name:
            return row
    raise KeyError(f"no peaks for {kind!r} in {PEAKS_FILE.name}")


def least_s(flops: float, nbytes: float, peak_flops: float,
            peak_bytes_per_s: float) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the peak bandwidth."""
    return max(flops / peak_flops, nbytes / peak_bytes_per_s)


# ---------------------------------------------------------------------------
# attention (copies of the port's kernels/flash_attention.py)
# ---------------------------------------------------------------------------
def attention_pairs(s: int, t: int, causal: bool,
                    window: Optional[int] = None) -> int:
    """Unmasked (query, key) pairs of one (batch row, q head): all S x T
    unless causal; causal, query i (right-aligned, at qpos = T - S + i)
    sees the min(qpos + 1, window) keys up to qpos."""
    if not causal:
        return s * t
    w = window or t
    lo, hi = t - s + 1, t
    if w >= hi:
        return (lo + hi) * s // 2
    if w <= lo:
        return s * w
    return (lo + w) * (w - lo + 1) // 2 + (hi - w) * w


def attention_cost(b: int, hq: int, hkv: int, s: int, t: int, d: int,
                   itemsize: int, causal: bool = True,
                   window: Optional[int] = None) -> Tuple[int, int]:
    """(FLOPs, bytes) of one forward call on q (b, hq, s, d) and k, v
    (b, hkv, t, d): 4*D flops per unmasked pair; q, k and v read and the
    output written once."""
    flops = 4 * d * attention_pairs(s, t, causal, window) * b * hq
    nbytes = (2 * b * hq * s * d + 2 * b * hkv * t * d) * itemsize
    return flops, nbytes


# ---------------------------------------------------------------------------
# convolutions
# ---------------------------------------------------------------------------
def conv_cost(n: int, h: int, w: int, cin: int, cout: int, k: int,
              stride: int, groups: int = 1,
              itemsize: int = 4) -> Tuple[int, int, Tuple[int, int]]:
    """(FLOPs, bytes, (ho, wo)) of a SAME-padded convolution over n images
    of (h, w, cin): 2 flops a multiply-accumulate; input, weight and output
    each read or written once."""
    ho, wo = -(-h // stride), -(-w // stride)
    macs = n * ho * wo * cout * (cin // groups) * k * k
    nbytes = (n * h * w * cin + cout * (cin // groups) * k * k
              + n * ho * wo * cout) * itemsize
    return 2 * macs, nbytes, (ho, wo)


def convs_least_s(convs: Iterable[Tuple[int, int]], peak_flops: float,
                  peak_bytes_per_s: float) -> float:
    """Sum of each convolution call's least time, ``convs`` its (FLOPs,
    bytes)."""
    return sum(least_s(f, b, peak_flops, peak_bytes_per_s)
               for f, b in convs)


# ---------------------------------------------------------------------------
# the MoE decoder
# ---------------------------------------------------------------------------
def lm_model_flops_per_token(m: Dict, seq: int) -> float:
    """The model's forward FLOPs a token of a causal prefill of ``seq``
    tokens (the configuration's work, not a dispatch's): q, k, v and o
    projections, the top-k routed experts' SwiGLU products and the router,
    the causal scores and their weighted sum (half the S x S pairs on
    average), and the head."""
    d, hd = m["d_model"], m["head_dim"]
    qd, kvd = m["n_heads"] * hd, m["n_kv_heads"] * hd
    proj = 2 * d * (2 * qd + 2 * kvd)
    experts = m["top_k"] * 3 * 2 * d * m["d_ff"] + 2 * d * m["n_experts"]
    pairs = attention_pairs(seq, seq, True) / seq
    scores = 4 * hd * m["n_heads"] * pairs
    head = 2 * d * m["vocab"]
    return m["n_layers"] * (proj + experts + scores) + head
