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
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .ref import rglru_scan_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class ScanPlan(NamedTuple):
    route: str      # "step" or "staged"
    row_bytes: int  # bytes of a row of a block's channel tile (staged)
    piece: int      # steps a stage holds (0: the step route)
    stages: int     # pieces staged at once, in flight or being scanned
    threads: int    # threads a block


STEP = ScanPlan("step", 0, 0, 0, 0)
STAGED = ScanPlan("staged", 128, 64, 4, 256)
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


def _aligned(a: torch.Tensor, g: torch.Tensor) -> bool:
    return a.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0


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
    _, s, r = a.shape
    out = launch(a, g, h0, scan_plan(s, r, a.element_size(),
                                     _aligned(a, g)))
    _build.count_launch("rglru_scan")
    return out


def launch(a: torch.Tensor, g: torch.Tensor, h0: torch.Tensor,
           plan: ScanPlan):
    """One launch of the kernel on checked CUDA inputs along ``plan``
    (uncounted: :func:`rglru_scan` counts its calls)."""
    if not (a.is_contiguous() and g.is_contiguous()):
        raise ValueError("rglru_scan kernel needs contiguous a and g")
    _build.refuse_grad("rglru_scan", a, g, h0)
    b, s, r = a.shape
    if plan.route == "staged" and not staged_fits(r, a.element_size(),
                                                  _aligned(a, g)):
        raise ValueError(f"rglru_scan's staged route needs 16-byte aligned "
                         f"rows; got R {r} of {a.dtype}")
    h0_32 = h0.float().contiguous()
    y = torch.empty_like(a)
    h_last = torch.empty((b, r), dtype=torch.float32, device=a.device)
    fn = _kernel()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), g.data_ptr(), h0_32.data_ptr(), y.data_ptr(),
                 h_last.data_ptr(), _DTYPES[a.dtype], b, s, r, plan.row_bytes,
                 plan.piece, plan.stages, plan.threads, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed ({plan}): CUDA "
                           f"error {err}")
    return y, h_last


@functools.cache
def _kernel():
    fn = _build.load("rglru_scan").rglru_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
