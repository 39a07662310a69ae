"""RWKV6 WKV recurrence: the wrapper around ``csrc/rwkv6_scan.cu``.

``rwkv6_scan(r, k, v, w, u, s0)`` computes the function of the TPU kernel
``repro/kernels/rwkv6_scan.py``: per (batch, head), with an fp32 state
``S`` (D x D), ``y_t = r_t (S + diag(u) k_t^T v_t)`` and ``S <- diag(w_t) S
+ k_t^T v_t``.  r/k/v/w ``(B, H, S, D)`` (fp32 or bf16, one dtype), u
``(H, D)``, s0 ``(B, H, D, D)`` -> (y ``(B, H, S, D)`` in r's dtype, s_last
fp32).  Any S, and S = 1 is the decode step (the kernel stages chunks of
64 steps but takes a ragged last one).  CUDA tensors launch the
hand-written kernel; CPU tensors take the plain version
:func:`~repro_torch.kernels.ref.rwkv6_scan_ref`.  Any other case raises.

The kernel takes element strides for the batch, head and sequence axes of
r/k/v/w and of the output, so r/k/v/w may be ``(B, H, S, D)`` views of the
model's ``(B, S, H, D)`` projections; ``out`` (optional) is where y goes,
e.g. the ``(B, H, S, D)`` view of a ``(B, S, H, D)`` buffer, so the caller
reshapes it to ``(B, S, H * D)`` for free.  The kernel copies r/k/v/w rows
16 bytes at a time, so their base pointers and strides must be 16-byte
aligned (a contiguous projection's are).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .ref import rwkv6_scan_ref

HEAD_DIMS = (16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(r, k, v, w, u, s0, out) -> None:
    if r.dim() != 4 or any(x.shape != r.shape for x in (k, v, w)):
        raise ValueError(f"rwkv6_scan wants r/k/v/w of one (B,H,S,D) shape; "
                         f"got {[tuple(x.shape) for x in (r, k, v, w)]}")
    b, h, s, d = r.shape
    if s < 1 or u.shape != (h, d) or s0.shape != (b, h, d, d):
        raise ValueError(f"rwkv6_scan wants S >= 1, u ({h},{d}) and s0 "
                         f"({b},{h},{d},{d}); got S={s}, u "
                         f"{tuple(u.shape)}, s0 {tuple(s0.shape)}")
    if r.dtype not in _DTYPES or any(x.dtype != r.dtype for x in (k, v, w)):
        raise TypeError(f"rwkv6_scan takes r/k/v/w of one dtype of "
                        f"{list(_DTYPES)}; got "
                        f"{[x.dtype for x in (r, k, v, w)]}")
    if out is not None and (out.shape != r.shape or out.dtype != r.dtype):
        raise ValueError(f"rwkv6_scan out must be {tuple(r.shape)} "
                         f"{r.dtype}; got {tuple(out.shape)} {out.dtype}")
    devs = {x.device for x in (r, k, v, w, u, s0, out) if x is not None}
    if len(devs) != 1:
        raise ValueError(f"rwkv6_scan inputs on different devices: {devs}")


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
               out: Optional[torch.Tensor] = None):
    """r/k/v/w: (B, H, S, D); u: (H, D); s0: (B, H, D, D) -> (y, s_last).
    ``out``: optional (B, H, S, D) tensor of r's dtype that receives y."""
    _check(r, k, v, w, u, s0, out)
    if r.device.type == "cpu":
        y, s_last = rwkv6_scan_ref(r, k, v, w, u, s0)
        if out is None:
            return y, s_last
        out.copy_(y)
        return out, s_last
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on CUDA or CPU tensors, not "
                         f"{r.device}")
    b, h, s, d = r.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan kernel takes head dims {HEAD_DIMS}, "
                         f"got {d}")
    _build.refuse_grad("rwkv6_scan", r, k, v, w, u, s0)
    if out is None:
        out = torch.empty_like(r)
    if any(x.stride(-1) != 1 for x in (r, k, v, w, out)):
        raise ValueError("rwkv6_scan needs a contiguous head dim (stride 1 "
                         "on the last axis of r/k/v/w and out)")
    size = r.element_size()
    if any(x.data_ptr() % 16 or any(st * size % 16 for st in x.stride()[:3])
           for x in (r, k, v, w)):
        raise ValueError("rwkv6_scan needs 16-byte aligned r/k/v/w rows "
                         "(base pointer and batch/head/seq strides)")
    u32 = u.float().contiguous()
    s0_32 = s0.float().contiguous()
    s_last = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    strides = (ctypes.c_longlong * 15)(
        *(st for x in (r, k, v, w, out) for st in x.stride()[:3]))
    fn = _kernel()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u32.data_ptr(), s0_32.data_ptr(), out.data_ptr(),
                 s_last.data_ptr(), _DTYPES[r.dtype], b, h, s, d, strides,
                 stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error "
                           f"{err}")
    _build.count_launch("rwkv6_scan")
    return out, s_last


@functools.cache
def _kernel():
    fn = _build.load("rwkv6_scan").rwkv6_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
