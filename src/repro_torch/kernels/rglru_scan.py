"""RG-LRU recurrence: the wrapper around ``csrc/rglru_scan.cu``.

``rglru_scan(a, g, h0)`` computes the function of the TPU kernel
``repro/kernels/rglru_scan.py``: ``h_t = a_t h_{t-1} + g_t`` per channel
with an fp32 carry.  a/g ``(B, S, R)`` (fp32 or bf16, one dtype), h0
``(B, R)`` -> (y ``(B, S, R)`` in a's dtype, h_last ``(B, R)`` fp32).  There
is no chunk: any S, and S = 1 is the decode step.  CUDA tensors launch the
hand-written kernel (a and g contiguous); CPU tensors take the plain version
:func:`~repro_torch.kernels.ref.rglru_scan_ref`.  Any other case raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import rglru_scan_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(a: torch.Tensor, g: torch.Tensor, h0: torch.Tensor) -> None:
    if a.dim() != 3 or g.shape != a.shape or a.shape[1] < 1:
        raise ValueError(f"rglru_scan wants a/g of one (B,S,R) shape with "
                         f"S >= 1; got {tuple(a.shape)}, {tuple(g.shape)}")
    b, _, r = a.shape
    if h0.shape != (b, r):
        raise ValueError(f"rglru_scan wants h0 ({b},{r}); got "
                         f"{tuple(h0.shape)}")
    if a.dtype not in _DTYPES or g.dtype != a.dtype:
        raise TypeError(f"rglru_scan takes a/g of one dtype of "
                        f"{list(_DTYPES)}; got {a.dtype}, {g.dtype}")
    if not (a.device == g.device == h0.device):
        raise ValueError(f"rglru_scan inputs on different devices: "
                         f"{a.device}, {g.device}, {h0.device}")


def rglru_scan(a: torch.Tensor, g: torch.Tensor, h0: torch.Tensor):
    """a/g: (B, S, R); h0: (B, R) -> (y (B, S, R), h_last (B, R) fp32)."""
    _check(a, g, h0)
    if a.device.type == "cpu":
        return rglru_scan_ref(a, g, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on CUDA or CPU tensors, not "
                         f"{a.device}")
    if not (a.is_contiguous() and g.is_contiguous()):
        raise ValueError("rglru_scan kernel needs contiguous a and g")
    b, s, r = a.shape
    h0_32 = h0.float().contiguous()
    y = torch.empty_like(a)
    h_last = torch.empty((b, r), dtype=torch.float32, device=a.device)
    fn = _kernel()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), g.data_ptr(), h0_32.data_ptr(), y.data_ptr(),
                 h_last.data_ptr(), _DTYPES[a.dtype], b, s, r, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err}")
    _build.count_launch("rglru_scan")
    return y, h_last


@functools.cache
def _kernel():
    fn = _build.load("rglru_scan").rglru_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
