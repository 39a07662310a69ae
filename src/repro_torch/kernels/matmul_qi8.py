"""int8 matrix product: the wrapper around ``csrc/matmul_qi8.cu``.

``matmul_qi8(x, w)`` computes the function of the TPU kernel
``repro/kernels/matmul_qi8.py``: x ``(M, K)`` int8 times w ``(K, N)`` int8
-> ``(M, N)`` int32, exact.  It takes any (M, K, N), as the reference's
public wrapper (``repro/kernels/ops.py`` ``matmul_qi8``) does off the TPU:
the Pallas function's ``block=`` argument and its assert that the shape
divides the block are the TPU's (8, 128) / MXU tiling, and the CUDA kernel
masks its ragged edge tiles itself (zero-fill on load, so any K is exact).
CUDA tensors launch the hand-written kernel (row-major, contiguous); CPU
tensors take the plain version :func:`~repro_torch.kernels.ref.matmul_qi8_ref`.
Any other case raises.  The scaled int8 API (``quantize_int8``,
``matmul_qi8`` with scales, ``quantized_dense``) is :mod:`.quant`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import matmul_qi8_ref

_MAX_ROWS = 65535 * 64          # the grid's y extent x the kernel's rows


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_qi8 wants x (M,K) and w (K,N); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"matmul_qi8 takes int8 x and w; got {x.dtype}, "
                        f"{w.dtype}")
    if x.device != w.device:
        raise ValueError(f"matmul_qi8 inputs on different devices: "
                         f"{x.device}, {w.device}")


def matmul_qi8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M, K) int8; w: (K, N) int8 -> (M, N) int32."""
    _check(x, w)
    if x.device.type == "cpu":
        return matmul_qi8_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_qi8 runs on CUDA or CPU tensors, not "
                         f"{x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("matmul_qi8 kernel needs row-major contiguous x "
                         "and w")
    (m, k), n = x.shape, w.shape[1]
    if m > _MAX_ROWS:
        raise ValueError(f"matmul_qi8 kernel takes at most {_MAX_ROWS} "
                         f"rows, got {m}")
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    if m == 0 or n == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, stream)
    if err != 0:
        raise RuntimeError(f"matmul_qi8 kernel launch failed: CUDA error "
                           f"{err}")
    _build.count_launch("matmul_qi8")
    return out


@functools.cache
def _kernel():
    fn = _build.load("matmul_qi8").matmul_qi8_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
