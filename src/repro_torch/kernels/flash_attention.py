"""Flash-attention forward: the wrapper around ``csrc/flash_attention.cu``.

``flash_attention(q, k, v, causal, window)`` computes the function of the
TPU kernel ``repro/kernels/flash_attention.py`` (q ``(B, Hq, S, D)``, k/v
``(B, Hkv, T, D)``, GQA, right-aligned causal queries, fp32 softmax, output
in q's dtype), plus the local-attention window of the reference's
``full_attention`` (recurrentgemma's attention layers).  CUDA tensors launch the hand-written kernel; CPU tensors take
the plain version :func:`~repro_torch.kernels.ref.flash_attention_ref`.
Any other case raises.

The kernel takes element strides for the batch, head and sequence axes, so
q/k/v may be transposed views of ``(B, S, H, D)`` projections as long as the
head dim is contiguous.  The output is allocated with q's layout
(``torch.empty_like``), so for such a q the caller's transpose back to
``(B, S, H, D)`` is contiguous again.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention wants q (B,Hq,S,D) and k/v "
                         f"(B,Hkv,T,D) of one shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, s, d = q.shape
    bk, hkv, t, dk = k.shape
    if bk != b or dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: batch and head dim must match "
                         f"and Hq must be a multiple of Hkv; got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if causal and s > t:
        raise ValueError(f"causal flash_attention needs S <= T (queries "
                         f"right-aligned to the keys); got S={s}, T={t}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention window must be >= 1, got "
                         f"{window}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes one dtype of "
                        f"{list(_DTYPES)}; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention inputs on different devices: "
                         f"{q.device}, {k.device}, {v.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, S, D); k/v: (B, Hkv, T, D) -> (B, Hq, S, D).

    When S != T the queries are right-aligned: query i sits at absolute
    position qpos = T - S + i.  ``window``: key kpos is visible only when
    kpos > qpos - window (the kernel never visits the KV tiles before a
    query tile's window)."""
    _check(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, "
                         f"not {q.device}")
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {d}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention needs a contiguous head dim "
                         "(stride 1 on the last axis)")
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(
        *(st for x in (q, k, v, out) for st in x.stride()[:3]))
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], b, hq, hkv, s, t, d, strides,
                 int(causal), window or 0, d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    _build.count_launch("flash_attention")
    return out


@functools.cache
def _kernel():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
