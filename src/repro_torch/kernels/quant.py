"""Per-tensor symmetric int8 quantization (the Edge TPU scheme, paper §2.1):
the port of the int8 API of ``repro/kernels/ops.py`` (``quantize_int8``,
the scaled ``matmul_qi8`` and ``quantized_dense``).

The int32 product goes through :func:`repro_torch.kernels.matmul_qi8.matmul_qi8`
(the hand-written kernel for CUDA tensors, its plain version for CPU
tensors).  The reference's ``quantized_dense`` calls its oracle instead of
its kernel; the int32 product is exact either way, so the function is the
same.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import matmul_qi8 as _mm


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (q int8, scale fp32 0-d) with q * scale ~= x: scale =
    max(amax, 1e-8) / 127, q = clip(round(x / scale), -127, 127) with
    round half to even (``torch.round``, as ``jnp.round``)."""
    amax = torch.clamp(x.abs().max(), min=1e-8)
    scale = (amax / 127.0).to(torch.float32)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def matmul_qi8(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
               w_scale: torch.Tensor) -> torch.Tensor:
    """Quantized matmul -> fp32 (dequantized): the int32 product of x_q
    (M,K) and w_q (K,N) int8, cast to fp32, times x_scale, then w_scale."""
    return _mm.matmul_qi8(x_q, w_q).to(torch.float32) * x_scale * w_scale


def quantized_dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 in/out dense through the int8 path (quantize -> mm -> dequant)."""
    xq, sx = quantize_int8(x)
    wq, sw = quantize_int8(w)
    return matmul_qi8(xq, wq, sx, sw)
