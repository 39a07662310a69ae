"""RG-LRU recurrence: the wrapper around ``csrc/rglru_scan.cu``.

``rglru_scan(a, g, h0)`` computes the function of the TPU kernel
``repro/kernels/rglru_scan.py``: ``h_t = a_t h_{t-1} + g_t`` per channel
with an fp32 carry.  a/g ``(B, S, R)`` (fp32 or bf16, one dtype), h0
``(B, R)`` -> (y ``(B, S, R)`` in a's dtype, h_last ``(B, R)`` fp32).  Any S
and any R; S = 1 is the decode step.  CUDA tensors launch the hand-written
kernel (a and g contiguous); CPU tensors take the plain version
:func:`~repro_torch.kernels.ref.rglru_scan_ref`.  Any other case raises.

The kernel has two routes, and the choice is host arithmetic, pinned by
the CPU tests: :func:`scan_plan` sends a short sequence to the step route
(one thread per channel walks S with its loads a few steps ahead) and a
longer one to the staged route, where a block stages a tile of channels
piece by piece along S into shared memory, several pieces in flight, and
walks each piece in order.  Both routes run the step recurrence's FMAs in
the same order, so their results are equal bit for bit, and either is one
CUDA launch a call.

While autograd records and an input requires grad, the call goes through
a :class:`torch.autograd.Function` whose forward is the same launch with
the kernel's checkpoint epilogue: it also writes the fp32 carry at the
start of every piece of 64 steps, (B, ceil(S / 64), R) (2.1 MB at
recurrentgemma-9b's training shape (8, 1024, 4096)).  The Function saves
a, g, h0 and those checkpoints, not y; its backward is
:func:`rglru_scan_bwd`, the hand-written backward kernel
``csrc/rglru_scan_bwd.cu`` (counted as ``rglru_scan_bwd``), which starts
each piece from its checkpoint and recomputes the carry from a and g.  On
CPU tensors the forward and the checkpoints are the plain
:func:`~repro_torch.kernels.ref.rglru_scan_ref` and
:func:`~repro_torch.kernels.ref.rglru_scan_checkpoints_ref`, the backward
the plain :func:`~repro_torch.kernels.ref.rglru_scan_bwd_ref`.  Otherwise
(serving, ``torch.no_grad``) nothing is saved and no checkpoint written.
A remat's first forward writes the checkpoints and has them dropped.

``meta`` tensors take the kernels' route up to the launch: the outputs
come back with their shapes and dtypes and nothing runs.  Every call on
the card or on ``meta`` reports :func:`scan_cost` or
:func:`scan_bwd_cost` to ``_build.report_cost``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from . import _build
from .ref import (RGLRU_PIECE, rglru_scan_bwd_ref,
                  rglru_scan_checkpoints_ref, rglru_scan_ref)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class ScanPlan(NamedTuple):
    route: str      # "step" or "staged"
    row_bytes: int  # bytes of a row of a block's channel tile (staged)
    piece: int      # steps a stage holds (0: the step route)
    stages: int     # pieces staged at once, in flight or being scanned
    threads: int    # threads a block


STEP = ScanPlan("step", 0, 0, 0, 0)
STAGED = ScanPlan("staged", 128, 64, 4, 256)
# the backward's staged route: pieces are the checkpoints' (RGLRU_PIECE)
BWD_STAGED = ScanPlan("staged", 128, RGLRU_PIECE, 2, 256)
# below this S the step route's loads a few steps ahead are in flight as
# early as a staged block's, and at the decode loop's 16 rows it is faster
STAGED_MIN_S = 64


def staged_fits(r: int, itemsize: int, aligned: bool = True) -> bool:
    """Whether the staged route takes rows of ``r`` channels: its 16-byte
    copies need every row (and the base pointers, ``aligned``) on 16
    bytes."""
    return aligned and r * itemsize % 16 == 0


def scan_plan(s: int, r: int, itemsize: int = 4,
              aligned: bool = True) -> ScanPlan:
    """The route of a call on ``(B, s, r)`` inputs of ``itemsize`` bytes:
    the staged route from :data:`STAGED_MIN_S` steps on rows it takes
    (:func:`staged_fits`), else the step route."""
    if s >= STAGED_MIN_S and staged_fits(r, itemsize, aligned):
        return STAGED
    return STEP


def bwd_plan(r: int, itemsize: int = 4, aligned: bool = True) -> ScanPlan:
    """The backward's route on rows of ``r`` channels of ``itemsize``
    bytes: :data:`BWD_STAGED` on rows its 16-byte copies take
    (:func:`staged_fits`; ``aligned``: the base pointers of a, g, dy and
    the checkpoints), at any S, else the step route."""
    return BWD_STAGED if staged_fits(r, itemsize, aligned) else STEP


def checkpoints_shape(a: torch.Tensor):
    """(B, ceil(S / RGLRU_PIECE), R): the checkpoint epilogue's output."""
    b, s, r = a.shape
    return (b, -(-s // RGLRU_PIECE), r)


def scan_cost(a: torch.Tensor, with_checkpoints: bool = False):
    """(FLOPs, bytes) of one forward call: 2 operations (a FMA) per
    element; a and g read and y written once in a's dtype, h0 read and
    h_last written in fp32, and with ``with_checkpoints`` the fp32
    checkpoints written."""
    b, s, r = a.shape
    nbytes = 3 * b * s * r * a.element_size() + 2 * b * r * 4
    if with_checkpoints:
        nbytes += 4 * math.prod(checkpoints_shape(a))
    return 2 * b * s * r, nbytes


def scan_bwd_cost(a: torch.Tensor, checkpoints: bool = False):
    """(FLOPs, bytes) of one backward call: 3 operations per element; a,
    g and dy read and da, dg written once in a's dtype, h0 and dh_last
    read and dh0 written in fp32: the function's floor, and the bound.
    With ``checkpoints``, also the read of the fp32 checkpoints that the
    kernel starts each piece from (a choice of this kernel, which a walk
    from h0 could avoid), as the wrapper reports its traffic."""
    b, s, r = a.shape
    nbytes = 5 * b * s * r * a.element_size() + 3 * b * r * 4
    if checkpoints:
        nbytes += 4 * math.prod(checkpoints_shape(a))
    return 3 * b * s * r, nbytes


def _aligned(*xs: torch.Tensor) -> bool:
    return all(x.data_ptr() % 16 == 0 for x in xs)


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
    """a/g: (B, S, R); h0: (B, R) -> (y (B, S, R), h_last (B, R) fp32).
    Differentiable in a, g and h0."""
    _check(a, g, h0)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (a, g, h0)):
        return _RGLRUScan.apply(a, g, h0)
    if a.device.type == "cpu":
        return rglru_scan_ref(a, g, h0)
    return _forward(a, g, h0)[:2]


def _forward(a: torch.Tensor, g: torch.Tensor, h0: torch.Tensor,
             with_checkpoints: bool = False):
    """One counted launch of the forward kernel on checked CUDA (or meta)
    inputs -> (y, h_last, checkpoints): the (B, ceil(S / 64), R) fp32
    carries of its checkpoint epilogue with ``with_checkpoints``, else None
    (the launch without it)."""
    _cuda_check(a)
    _, s, r = a.shape
    ckpt = (torch.empty(checkpoints_shape(a), dtype=torch.float32,
                        device=a.device) if with_checkpoints else None)
    y, h_last = launch(a, g, h0, scan_plan(s, r, a.element_size(),
                                           _aligned(a, g)), ckpt)
    if a.device.type != "meta":
        _build.count_launch("rglru_scan", a.device)
    _build.report_cost("rglru_scan", scan_cost, a, with_checkpoints)
    return y, h_last, ckpt


class _RGLRUScan(torch.autograd.Function):
    """The kernel, its checkpoint epilogue and its backward; the CPU
    route's are the plain versions."""

    @staticmethod
    def forward(ctx, a, g, h0):
        if a.device.type == "cpu":
            y, h_last = rglru_scan_ref(a, g, h0)
            ckpt = rglru_scan_checkpoints_ref(a, g, h0)
        else:
            y, h_last, ckpt = _forward(a, g, h0, with_checkpoints=True)
        ctx.save_for_backward(a, g, h0, ckpt)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        a, g, h0, ckpt = ctx.saved_tensors
        da, dg, dh0 = rglru_scan_bwd(a, g, h0, dy, dh_last, ckpt)
        return da, dg, dh0.to(h0.dtype)


def _cuda_check(a: torch.Tensor) -> None:
    if a.device.type not in ("cuda", "meta"):
        raise ValueError(f"rglru_scan runs on CUDA, CPU or meta tensors, not "
                         f"{a.device}")


def rglru_scan_bwd(a: torch.Tensor, g: torch.Tensor, h0: torch.Tensor,
                   dy: Optional[torch.Tensor],
                   dh_last: Optional[torch.Tensor],
                   checkpoints: Optional[torch.Tensor] = None):
    """The gradient of :func:`rglru_scan` given those of y (``dy``) and
    h_last (``dh_last``; either None: zero) -> (da, dg) in a's dtype, dh0
    fp32.  ``checkpoints``: the (B, ceil(S / 64), R) carries of the
    forward's checkpoint epilogue (or of
    :func:`~repro_torch.kernels.ref.rglru_scan_checkpoints_ref`); None: a
    forward launch with the epilogue writes them first (counted as
    ``rglru_scan``).  CUDA tensors: one counted launch of the backward
    kernel, which reads a, g, dy and the checkpoints and no y; CPU
    tensors: the plain
    :func:`~repro_torch.kernels.ref.rglru_scan_bwd_ref`."""
    _check(a, g, h0)
    for name, x, shape in (("dy", dy, a.shape),
                           ("dh_last", dh_last, h0.shape),
                           ("checkpoints", checkpoints,
                            checkpoints_shape(a))):
        if x is not None and (tuple(x.shape) != tuple(shape)
                              or x.device != a.device):
            raise ValueError(f"rglru_scan_bwd wants {name} of shape "
                             f"{tuple(shape)} on {a.device}; got "
                             f"{tuple(x.shape)} on {x.device}")
    if a.device.type == "cpu":
        return rglru_scan_bwd_ref(a, g, h0, dy, dh_last, checkpoints)
    _cuda_check(a)
    a, g = a.contiguous(), g.contiguous()
    if checkpoints is None:
        checkpoints = _forward(a, g, h0, with_checkpoints=True)[2]
    checkpoints = checkpoints.float().contiguous()
    dy = (torch.zeros_like(a) if dy is None
          else dy.to(a.dtype).contiguous())
    if dh_last is not None:
        dh_last = dh_last.float().contiguous()
    _build.report_cost("rglru_scan_bwd", scan_bwd_cost, a, True)
    out = bwd_launch(a, g, checkpoints, dy, dh_last,
                     bwd_plan(a.shape[2], a.element_size(),
                              _aligned(a, g, dy, checkpoints)))
    if a.device.type != "meta":
        _build.count_launch("rglru_scan_bwd", a.device)
    return out


def bwd_launch(a: torch.Tensor, g: torch.Tensor, checkpoints: torch.Tensor,
               dy: torch.Tensor, dh_last: Optional[torch.Tensor],
               plan: ScanPlan):
    """One launch of the backward kernel along ``plan`` on contiguous CUDA
    a, g, dy (a's dtype), fp32 checkpoints and dh_last (or None) ->
    (da, dg, dh0) (uncounted: :func:`rglru_scan_bwd` counts its calls;
    ``meta`` inputs: the outputs, no launch)."""
    if not all(x.is_contiguous() for x in (a, g, dy, checkpoints)):
        raise ValueError("rglru_scan_bwd kernel needs contiguous a, g, dy "
                         "and checkpoints")
    b, s, r = a.shape
    if plan.route == "staged" and not staged_fits(
            r, a.element_size(), _aligned(a, g, dy, checkpoints)):
        raise ValueError(f"rglru_scan_bwd's staged route needs 16-byte "
                         f"aligned rows; got R {r} of {a.dtype}")
    da, dg = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty((b, r), dtype=torch.float32, device=a.device)
    if a.device.type == "meta":
        return da, dg, dh0
    fn = _bwd_kernel()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), g.data_ptr(), checkpoints.data_ptr(),
                 dy.data_ptr(),
                 None if dh_last is None else dh_last.data_ptr(),
                 da.data_ptr(), dg.data_ptr(), dh0.data_ptr(),
                 _DTYPES[a.dtype], b, s, r, plan.row_bytes, plan.piece,
                 plan.stages, plan.threads, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan_bwd kernel launch failed ({plan}): "
                           f"CUDA error {err}")
    return da, dg, dh0


def launch(a: torch.Tensor, g: torch.Tensor, h0: torch.Tensor,
           plan: ScanPlan, checkpoints: Optional[torch.Tensor] = None):
    """One launch of the kernel on checked CUDA inputs along ``plan``
    (uncounted: :func:`rglru_scan` counts its calls; ``meta`` inputs: the
    outputs, no launch); with ``checkpoints`` (a contiguous
    (B, ceil(S / 64), R) fp32 tensor) the checkpoint epilogue writes
    them."""
    if not (a.is_contiguous() and g.is_contiguous()):
        raise ValueError("rglru_scan kernel needs contiguous a and g")
    b, s, r = a.shape
    if plan.route == "staged" and not staged_fits(r, a.element_size(),
                                                  _aligned(a, g)):
        raise ValueError(f"rglru_scan's staged route needs 16-byte aligned "
                         f"rows; got R {r} of {a.dtype}")
    h0_32 = h0.float().contiguous()
    y = torch.empty_like(a)
    h_last = torch.empty((b, r), dtype=torch.float32, device=a.device)
    if a.device.type == "meta":
        return y, h_last
    fn = _kernel()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), g.data_ptr(), h0_32.data_ptr(), y.data_ptr(),
                 h_last.data_ptr(),
                 None if checkpoints is None else checkpoints.data_ptr(),
                 _DTYPES[a.dtype], b, s, r, plan.row_bytes, plan.piece,
                 plan.stages, plan.threads, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed ({plan}): CUDA "
                           f"error {err}")
    return y, h_last


@functools.cache
def _kernel():
    fn = _build.load("rglru_scan").rglru_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel():
    fn = _build.load("rglru_scan_bwd").rglru_scan_bwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
