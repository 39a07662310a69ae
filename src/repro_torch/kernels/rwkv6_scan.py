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

While autograd records and an input requires grad, the call goes through
a :class:`torch.autograd.Function` whose forward is the same launch (on
CUDA into a new ``(B, S, H, D)`` buffer returned as its ``(B, H, S, D)``
view; ``out`` is not written) with the kernel's checkpoint epilogue: it
also writes the state at the start of every 8-step piece, (B, H, ceil(S /
8), D, D) fp32 (537 MB at rwkv6-1.6b's training shape (8, 32, 1024, 64)).
The Function saves r, k, v, w, u, s0 and those states; its backward is
:func:`rwkv6_scan_bwd`, the hand-written backward kernel
``csrc/rwkv6_scan_bwd.cu`` (counted as ``rwkv6_scan_bwd``), which starts
each piece from its saved state.  On CPU tensors the forward and the
states are the plain :func:`~repro_torch.kernels.ref.rwkv6_scan_ref` and
:func:`~repro_torch.kernels.ref.rwkv6_scan_states_ref`, the backward the
plain :func:`~repro_torch.kernels.ref.rwkv6_scan_bwd_ref`.  Otherwise
(serving, ``torch.no_grad``) nothing is saved and no state is written.
Under :func:`no_saved_states` (a remat's first forward, whose saved
tensors ``torch.utils.checkpoint`` drops) the Function writes no states
either and saves a zero-stride stand-in of their shape; the recompute
that the backward runs writes them.

``meta`` tensors take the kernels' route up to the launch: y, s_last, the
piece states and the gradients come back with the shapes, dtypes and
layouts a launch gives, and nothing runs.  Every call on the card or on
``meta`` reports :func:`scan_cost` or :func:`scan_bwd_cost` to
``_build.report_cost``.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import threading
from typing import Optional

import torch

from . import _build
from .ref import (RWKV6_PIECE, rwkv6_scan_bwd_ref, rwkv6_scan_ref,
                  rwkv6_scan_states_ref)

HEAD_DIMS = (16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_skip = threading.local()


@contextlib.contextmanager
def no_saved_states():
    """While active (in this thread), a recording forward writes no piece
    states and saves a stand-in: for the first forward of a
    ``torch.utils.checkpoint`` region, whose saved tensors are dropped and
    recomputed (``checkpoint(..., context_fn=lambda: (no_saved_states(),
    contextlib.nullcontext()))``)."""
    before = getattr(_skip, "on", False)
    _skip.on = True
    try:
        yield
    finally:
        _skip.on = before


def _states_shape(r: torch.Tensor):
    b, h, s, d = r.shape
    return (b, h, -(-s // RWKV6_PIECE), d, d)


def scan_cost(r: torch.Tensor, with_states: bool = False):
    """(FLOPs, bytes) of one forward call: 4 operations per state element
    per step; r, k, v and w read and y written once in r's dtype, the
    fp32 u, s0 read and s_last written, and with ``with_states`` the fp32
    piece states written."""
    b, h, s, d = r.shape
    nbytes = (5 * b * h * s * d * r.element_size() + 2 * b * h * d * d * 4
              + h * d * 4)
    if with_states:
        nbytes += 4 * math.prod(_states_shape(r))
    return 4 * b * h * s * d * d, nbytes


def scan_bwd_cost(r: torch.Tensor, states: bool = False):
    """(FLOPs, bytes) of one backward call: 8 operations per state element
    per step; r, k, v, w and dy read and dr, dk, dv, dw written once in
    r's dtype, the fp32 s0 and ds_last read, ds0 written, u read and du
    written: the function's floor, and the bound.  With ``states``, also
    the read of the fp32 piece states, the kernel's checkpoints (a choice
    of this kernel, which a recompute could avoid), as the wrapper reports
    its traffic."""
    b, h, s, d = r.shape
    nbytes = (9 * b * h * s * d * r.element_size() + 3 * b * h * d * d * 4
              + 2 * h * d * 4)
    if states:
        nbytes += 4 * math.prod(_states_shape(r))
    return 8 * b * h * s * d * d, nbytes


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
    ``out``: optional (B, H, S, D) tensor of r's dtype that receives y
    when autograd does not record.  Differentiable in every input."""
    _check(r, k, v, w, u, s0, out)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (r, k, v, w, u, s0)):
        return _RWKV6Scan.apply(r, k, v, w, u, s0)
    if r.device.type == "cpu":
        y, s_last = rwkv6_scan_ref(r, k, v, w, u, s0)
        if out is None:
            return y, s_last
        out.copy_(y)
        return out, s_last
    return _forward(r, k, v, w, u, s0, out)[:2]


class _RWKV6Scan(torch.autograd.Function):
    """The kernel, its checkpoint epilogue and its backward; the CPU
    route's are the plain versions."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        skip = getattr(_skip, "on", False)
        if r.device.type == "cpu":
            y, s_last = rwkv6_scan_ref(r, k, v, w, u, s0)
            states = None if skip else rwkv6_scan_states_ref(k, v, w, s0)
        else:
            b, h, s, d = r.shape
            out = torch.empty((b, s, h, d), dtype=r.dtype,
                              device=r.device).transpose(1, 2)
            y, s_last, states = _forward(r, k, v, w, u, s0, out,
                                         with_states=not skip)
        if states is None:      # shape, dtype and device; never read
            states = torch.empty((), dtype=torch.float32,
                                 device=r.device).expand(_states_shape(r))
        ctx.save_for_backward(r, k, v, w, u, s0, states)
        ctx.set_materialize_grads(False)
        return y, s_last

    @staticmethod
    def backward(ctx, dy, ds_last):
        r, k, v, w, u, s0, states = ctx.saved_tensors
        if 0 in states.stride():    # the stand-in: recompute them
            states = None
        dr, dk, dv, dw, du, ds0 = rwkv6_scan_bwd(r, k, v, w, u, s0, dy,
                                                 ds_last, states)
        return dr, dk, dv, dw, du.to(u.dtype), ds0.to(s0.dtype)


def _cuda_checks(r: torch.Tensor) -> None:
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"rwkv6_scan runs on CUDA, CPU or meta tensors, not "
                         f"{r.device}")
    if r.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan kernel takes head dims {HEAD_DIMS}, "
                         f"got {r.shape[-1]}")


def _rows_aligned(*xs: torch.Tensor) -> bool:
    """Whether the kernels' 16-byte copies can read the rows of each x: the
    head dim contiguous, the base pointer and the batch, head and sequence
    strides on 16 bytes."""
    return all(x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and not any(
        st * x.element_size() % 16 for st in x.stride()[:3]) for x in xs)


def _forward(r, k, v, w, u, s0, out, with_states=False):
    """One counted launch of the forward kernel on checked CUDA inputs ->
    (y, s_last, states): the piece states of its checkpoint epilogue with
    ``with_states``, else None (the launch without it)."""
    _cuda_checks(r)
    b, h, s, d = r.shape
    if out is None:
        out = torch.empty_like(r)
    if any(x.stride(-1) != 1 for x in (r, k, v, w, out)):
        raise ValueError("rwkv6_scan needs a contiguous head dim (stride 1 "
                         "on the last axis of r/k/v/w and out)")
    if not _rows_aligned(r, k, v, w):
        raise ValueError("rwkv6_scan needs 16-byte aligned r/k/v/w rows "
                         "(base pointer and batch/head/seq strides)")
    u32 = u.float().contiguous()
    s0_32 = s0.float().contiguous()
    s_last = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    states = (torch.empty(_states_shape(r), dtype=torch.float32,
                          device=r.device) if with_states else None)
    _build.report_cost("rwkv6_scan", scan_cost, r, with_states)
    if r.device.type == "meta":
        return out, s_last, states
    strides = (ctypes.c_longlong * 15)(
        *(st for x in (r, k, v, w, out) for st in x.stride()[:3]))
    fn = _kernel()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u32.data_ptr(), s0_32.data_ptr(), out.data_ptr(),
                 s_last.data_ptr(),
                 None if states is None else states.data_ptr(),
                 _DTYPES[r.dtype], b, h, s, d, strides, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error "
                           f"{err}")
    _build.count_launch("rwkv6_scan", r.device)
    return out, s_last, states


def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                   dy: Optional[torch.Tensor],
                   ds_last: Optional[torch.Tensor],
                   states: Optional[torch.Tensor] = None):
    """The gradient of :func:`rwkv6_scan` given those of y (``dy``) and
    s_last (``ds_last``; either None: zero) -> (dr, dk, dv, dw) in the
    inputs' dtype and layouts, (du, ds0) fp32.  ``states``: the piece
    states of the forward's checkpoint epilogue (or of
    :func:`~repro_torch.kernels.ref.rwkv6_scan_states_ref`); None: a
    forward launch with the epilogue writes them first (counted as
    ``rwkv6_scan``).  CUDA tensors: one counted call of the backward kernel
    (two launches: the gradient, then du's fixed-order sum over the batch
    rows); CPU tensors: the plain
    :func:`~repro_torch.kernels.ref.rwkv6_scan_bwd_ref`."""
    _check(r, k, v, w, u, s0, None)
    for name, x, shape in (("dy", dy, r.shape), ("ds_last", ds_last,
                                                 s0.shape),
                           ("states", states, _states_shape(r))):
        if x is not None and (tuple(x.shape) != tuple(shape)
                              or x.device != r.device):
            raise ValueError(f"rwkv6_scan_bwd wants {name} of shape "
                             f"{tuple(shape)} on {r.device}; got "
                             f"{tuple(x.shape)} on {x.device}")
    if r.device.type == "cpu":
        return rwkv6_scan_bwd_ref(r, k, v, w, u, s0, dy, ds_last, states)
    _cuda_checks(r)
    b, h, s, d = r.shape
    if not _rows_aligned(r, k, v, w):
        raise ValueError("rwkv6_scan_bwd needs 16-byte aligned r/k/v/w rows "
                         "(base pointer and batch/head/seq strides)")
    if states is None:
        states = _forward(r, k, v, w, u, s0, None, with_states=True)[2]
    states = states.float().contiguous()
    if dy is None:
        dy = torch.zeros_like(r)
    elif dy.dtype != r.dtype or not _rows_aligned(dy):
        dy = dy.to(r.dtype).contiguous()
    if ds_last is not None:
        ds_last = ds_last.float().contiguous()
    # r/k/v/w's layouts (or contiguous ones): rows aligned as theirs are
    grads = [torch.empty_like(x) for x in (r, k, v, w)]
    dev = r.device
    du_part = torch.empty((b, h, d), dtype=torch.float32, device=dev)
    du = torch.empty((h, d), dtype=torch.float32, device=dev)
    ds0 = torch.empty((b, h, d, d), dtype=torch.float32, device=dev)
    u32 = u.float().contiguous()
    _build.report_cost("rwkv6_scan_bwd", scan_bwd_cost, r, True)
    if dev.type == "meta":
        return (*grads, du, ds0)
    strides = (ctypes.c_longlong * 27)(
        *(st for x in (r, k, v, w, dy, *grads) for st in x.stride()[:3]))
    fn = _bwd_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u32.data_ptr(), states.data_ptr(), dy.data_ptr(),
                 None if ds_last is None else ds_last.data_ptr(),
                 *(x.data_ptr() for x in grads), du_part.data_ptr(),
                 du.data_ptr(), ds0.data_ptr(), _DTYPES[r.dtype], b, h, s,
                 d, strides, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan_bwd kernel launch failed: CUDA "
                           f"error {err}")
    _build.count_launch("rwkv6_scan_bwd", dev)
    return (*grads, du, ds0)


@functools.cache
def _kernel():
    fn = _build.load("rwkv6_scan").rwkv6_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel():
    fn = _build.load("rwkv6_scan_bwd").rwkv6_scan_bwd
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
