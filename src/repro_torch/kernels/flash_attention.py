"""Flash attention, forward and backward: the wrappers around
``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``.

``flash_attention(q, k, v, causal, window)`` computes the function of the
TPU kernel ``repro/kernels/flash_attention.py`` (q ``(B, Hq, S, D)``, k/v
``(B, Hkv, T, D)``, GQA, right-aligned causal queries, fp32 softmax, output
in q's dtype), plus the local-attention window of the reference's
``full_attention`` (recurrentgemma's attention layers).  CUDA tensors
launch the hand-written kernel; CPU tensors take the plain version
:func:`~repro_torch.kernels.ref.flash_attention_ref`.  Any other case
raises.

While autograd records and an input requires grad, the call goes through
a :class:`torch.autograd.Function`: its forward also writes each row's
log-sum-exp (the kernel's ``lse`` epilogue) and saves q, k, v and lse;
its backward is :func:`flash_attention_bwd`, the hand-written backward
kernel (three launches: each row's rowsum(P * dP), dK/dV, dQ; a fourth
sums head dim 256's dK/dV parts), or on CPU
tensors the plain :func:`~repro_torch.kernels.ref.flash_attention_bwd_ref`.
Otherwise (serving, ``torch.no_grad``) nothing is saved and no lse is
written.

``meta`` tensors take the kernels' route up to the launch: the outputs
(and lse, and the backward's gradients) come back with the shapes,
dtypes and layouts a launch gives, and nothing runs.  Every call on the
card or on ``meta`` reports :func:`attention_cost` or
:func:`attention_bwd_cost` to ``_build.report_cost``.

The forward's route is chosen by dtype, one route each: bf16 runs on the
tensor cores (``mma.sync``, its K/V tiles filled by 16-byte ``cp.async``),
fp32 on CUDA cores (tensor cores would mean TF32, a different function).
The bf16 route needs 16-byte aligned rows (:func:`aligned`); a bf16 input
that is not raises ``ValueError`` and falls back to nothing.  The backward
runs bf16 on the tensor cores at every head dim (the same alignment rule;
a misaligned ``do`` is copied contiguous first), from head dim 96 its
dK/dV launch handing dS to the dQ launch through a scratch buffer (batch
rows at most :data:`DS_SCRATCH_BYTES` of it a launch), and fp32 on CUDA
cores.

The kernels take element strides for the batch, head and sequence axes, so
q/k/v may be transposed views of ``(B, S, H, D)`` projections as long as the
head dim is contiguous.  Outputs and gradients are allocated with their
input's layout (``torch.empty_like``), so for such a q the caller's
transpose back to ``(B, S, H, D)`` is contiguous again.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .ref import flash_attention_bwd_ref, flash_attention_ref

HEAD_DIMS = (16, 32, 64, 96, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN = 16             # bytes of one cp.async
# the bf16 backward's scratch (dS tiles, head dim 256's dK/dV parts): batch
# rows are launched in groups whose scratch stays within this many bytes
# (one row at a time at the least)
DS_SCRATCH_BYTES = 1 << 30


def attention_pairs(s: int, t: int, causal: bool,
                    window: Optional[int] = None) -> int:
    """Unmasked (query, key) pairs of one (batch row, q head): all S x T
    unless causal; causal, query i (right-aligned, at qpos = T - S + i)
    sees the min(qpos + 1, window) keys up to qpos."""
    if not causal:
        return s * t
    w = window or t
    lo, hi = t - s + 1, t           # keys the first and last query see
    if w >= hi:
        return (lo + hi) * s // 2
    if w <= lo:
        return s * w
    return (lo + w) * (w - lo + 1) // 2 + (hi - w) * w


def attention_cost(q: torch.Tensor, k: torch.Tensor, causal: bool = True,
                   window: Optional[int] = None, with_lse: bool = False):
    """(FLOPs, bytes) of one forward call: 4*D flops per unmasked pair
    (the 2*D of a QK^T dot and the 2*D of P V); q, k and v read and the
    output written once, and with ``with_lse`` the fp32 (B, Hq, S)
    lse."""
    b, hq, s, d = q.shape
    flops = 4 * d * attention_pairs(s, k.shape[2], causal, window) * b * hq
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return flops, nbytes + (4 * b * hq * s if with_lse else 0)


def attention_bwd_cost(q: torch.Tensor, k: torch.Tensor,
                       causal: bool = True, window: Optional[int] = None):
    """(FLOPs, bytes) of one backward call: 5 products (QK^T recomputed,
    dV, dP, dQ, dK), 10*D flops per unmasked pair, 2.5 times the
    forward's; q, k, v, dO and lse read and dq, dk, dv written once."""
    b, hq, s, d = q.shape
    flops = 10 * d * attention_pairs(s, k.shape[2], causal, window) * b * hq
    nbytes = ((3 * q.numel() + 4 * k.numel()) * q.element_size()
              + 4 * b * hq * s)
    return flops, nbytes


def aligned(data_ptr: int, strides, sizes, itemsize: int) -> bool:
    """Whether the bf16 kernel's 16-byte copies can read a (B, H, S, D)
    tensor at ``data_ptr`` with element ``strides``: the base and every
    batch, head and sequence stride (in bytes) a multiple of 16.  The
    stride of an axis of size 1 is never stepped, so it is not asked."""
    return data_ptr % _ALIGN == 0 and all(
        size == 1 or st * itemsize % _ALIGN == 0
        for st, size in zip(strides[:3], sizes[:3]))


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
    query tile's window).  Differentiable in q, k and v."""
    _check(q, k, v, causal, window)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    return _forward(q, k, v, causal, window, with_lse=False)


class _FlashAttention(torch.autograd.Function):
    """The kernel with its backward; the CPU route's are the plain
    versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if q.device.type == "cpu":
            out, lse = flash_attention_ref(q, k, v, causal=causal,
                                           window=window, return_lse=True)
        else:
            out, lse = _forward(q, k, v, causal, window, with_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, lse, do, ctx.causal,
                                         ctx.window)
        return dq, dk, dv, None, None


def _cuda_checks(name: str, *xs: torch.Tensor) -> None:
    q = xs[0]
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name} runs on CUDA, CPU or meta tensors, not "
                         f"{q.device}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head dims {HEAD_DIMS}, got "
                         f"{q.shape[-1]}")
    if any(x.stride(-1) != 1 for x in xs):
        raise ValueError(f"{name} needs a contiguous head dim (stride 1 on "
                         f"the last axis)")


def _is_aligned(x: torch.Tensor) -> bool:
    return aligned(x.data_ptr(), x.stride(), x.shape, x.element_size())


def _check_aligned(name: str, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> None:
    bad = [n for n, x in zip("qkv", (q, k, v)) if not _is_aligned(x)]
    if bad:
        raise ValueError(f"bf16 {name} needs 16-byte aligned rows (data_ptr "
                         f"and batch, head and sequence strides); "
                         f"{', '.join(bad)} are not")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, window: Optional[int], with_lse: bool):
    """One launch of the forward kernel: out, or (out, lse) with the fp32
    (B, Hq, S) log-sum-exp when ``with_lse``."""
    _cuda_checks("flash_attention", q, k, v)
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty(b, hq, s, dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.dtype == torch.bfloat16:
        _check_aligned("flash_attention", q, k, v)
    _build.report_cost("flash_attention", attention_cost, q, k, causal,
                       window, with_lse)
    if q.device.type == "meta":
        return out if lse is None else (out, lse)
    strides = (ctypes.c_longlong * 12)(
        *(st for x in (q, k, v, out) for st in x.stride()[:3]))
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 _DTYPES[q.dtype], b, hq, hkv, s, t, d, strides,
                 int(causal), window or 0, d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    _build.count_launch("flash_attention", q.device)
    return out if lse is None else (out, lse)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None):
    """The gradient of :func:`flash_attention` in (q, k, v) -> (dq, dk,
    dv), each with its input's shape, dtype and layout: from the forward's
    inputs, its fp32 (B, Hq, S) ``lse`` and the output's gradient ``do``.
    CUDA tensors launch the backward kernel (counted once a call), CPU
    tensors take :func:`~repro_torch.kernels.ref.flash_attention_bwd_ref`."""
    _check(q, k, v, causal, window)
    b, hq, s, d = q.shape
    if do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd wants do of q's shape "
                         f"{tuple(q.shape)}; got {tuple(do.shape)}")
    if lse.shape != (b, hq, s) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd wants an fp32 lse of shape "
                         f"{(b, hq, s)}; got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, lse, do, causal=causal,
                                       window=window)
    do = do.to(q.dtype)
    if do.stride(-1) != 1 or (do.dtype == torch.bfloat16
                              and not _is_aligned(do)):
        do = do.contiguous()
    _cuda_checks("flash_attention_bwd", q, k, v, do)
    if q.dtype == torch.bfloat16:
        _check_aligned("flash_attention_bwd", q, k, v)
    lse = lse.contiguous()
    hkv, t = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty_like(lse)
    _build.report_cost("flash_attention_bwd", attention_bwd_cost, q, k,
                       causal, window)
    if q.device.type == "meta":
        return dq, dk, dv
    xs = (q, k, v, do, dq, dk, dv)
    strides = (ctypes.c_longlong * 21)(
        *(st for x in xs for st in x.stride()[:3]))
    chunk, scratch = b, None
    per_row = (_bwd_scratch()(hq, hkv, s, t, d, int(causal), window or 0)
               if q.dtype == torch.bfloat16 else 0)
    if per_row > 0:
        chunk = max(1, min(b, DS_SCRATCH_BYTES // per_row))
        scratch = torch.empty(chunk * per_row, dtype=torch.uint8,
                              device=q.device)
    fn = _bwd_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for b0 in range(0, b, chunk):
            # batch rows [b0, b0 + n): every pointer moved by b0 rows
            n = min(chunk, b - b0)
            ptr = [x.data_ptr() + b0 * x.stride(0) * x.element_size()
                   for x in xs]
            rows = b0 * hq * s * 4          # lse and delta are contiguous
            err = fn(*ptr[:4], lse.data_ptr() + rows,
                     delta.data_ptr() + rows,
                     None if scratch is None else scratch.data_ptr(),
                     *ptr[4:],
                     _DTYPES[q.dtype], n, hq, hkv, s, t, d, strides,
                     int(causal), window or 0, d ** -0.5, stream)
            if err != 0:
                raise RuntimeError(f"flash_attention_bwd kernel launch "
                                   f"failed: CUDA error {err}")
    _build.count_launch("flash_attention_bwd", q.device)
    return dq, dk, dv


@functools.cache
def _kernel():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_scratch():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_scratch
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_longlong
    return fn
