"""Depthwise convolution with its padding taken inside the kernel, and
the BN and activation after it in the kernel's epilogue: the wrapper
around ``csrc/dwconv.cu``.

``dwconv(x, w, b, stride, pads, bn, act)`` computes the CNN forward's
depthwise convolution (channel multiplier 1): NHWC ``x`` (N, H, W, C)
zero-padded by ``pads`` (``F.pad``'s order: left, right, top, bottom;
XLA's SAME pads from ``models/layers.py`` ``same_pads``), convolved channel
by channel with ``w`` (C, 1, k, k), the parameter as stored, plus ``b``
(C,) where given -> (N, OH, OW, C).  Given ``bn`` = (mean, var, gamma,
beta), each (C,), it then applies the inference BatchNorm and ``act``
(None, "relu" or "relu6") of
:func:`~repro_torch.kernels.bn_epilogue.bn_epilogue` to that output: the
CNN forward's depthwise ``conv``, ``bn`` and ``act`` nodes that
:class:`~repro_torch.models.layers.GraphModel` runs as one group.  It
replaces no TPU kernel (the reference leaves the convolution to XLA); it
replaces the port's ``F.pad`` and cuDNN grouped route, which wrote a
padded copy of every input, and the ``bn_epilogue`` launch that read the
depthwise output back.

CUDA tensors launch the kernel, one counted launch a call (``dwconv``;
counted again as ``dwconv.bn`` where it carries the epilogue) on the
current stream of x's card, which reads only the taps inside x: no padded
tensor is made.  Its output differs from the plain ops by the order of the
k * k fused multiply-adds (a few ulp of the output's scale); its epilogue
is ``bn_epilogue``'s arithmetic, so a fused call equals ``dwconv`` then
``bn_epilogue`` on the card bit for bit.  CPU tensors take the plain
version :func:`~repro_torch.kernels.ref.dwconv_ref`, the forward's
``F.pad`` and ``F.conv2d``, then ``bn_epilogue_ref``.  Any other case
raises: an ``act`` other than None, "relu" or "relu6", or an ``act``
without ``bn`` (``ValueError``, on every device); inputs that are not fp32
(``TypeError``); x not contiguous or not on 16 bytes, C not a multiple of
4, 2^31 elements or more in x or y, a weight that is not (C, 1, k, k) with
k 3, 5 or 7 (a channel multiplier other than 1 included), a bias or a
per-channel vector not contiguous of C, a stride other than 1 or 2, pads
outside [0, k) or no output, tensors on other devices (``ValueError``);
and an input that requires grad while autograd records (``RuntimeError``:
the kernel has no backward; the CNN forward runs the plain ops itself
there).  ``meta`` tensors take the kernel's route up to the launch and
return the output's shape.  Every call on the card or on ``meta`` reports
:func:`dwconv_cost` to ``_build.report_cost``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build
from .bn_epilogue import ACT_CODES
from .ref import EPILOGUE_ACTS, dwconv_ref

_F32 = torch.float32
MAX_ELEMENTS = 2 ** 31 - 1    # the kernel indexes in 32 bits
KERNEL_SIZES = (3, 5, 7)
STRIDES = (1, 2)
BnVectors = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def dwconv_cost(x: torch.Tensor, k: int, oh: int, ow: int, bias: bool,
                bn: bool = False, act: Optional[str] = None):
    """(FLOPs, bytes) of one call: 2 k^2 flops an output (one more with a
    bias; with the BN epilogue 4 more, and one for ``act``); x read, the
    weight (and bias, and the BN's 4 per-channel vectors) read and y
    written once, in fp32."""
    n, _, _, c = x.shape
    outs = n * oh * ow * c
    flops = (2 * k * k + bias + bn * (4 + (act is not None))) * outs
    return flops, 4 * (x.numel() + c * k * k + outs + (bias + 4 * bn) * c)


def _check(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           stride: int, pads: Tuple[int, int, int, int],
           bn: Optional[BnVectors]) -> Tuple[int, int]:
    """Raise unless the kernel takes these inputs; else (OH, OW)."""
    vectors = (b, *(bn or ()))
    if not (x.dtype is _F32 and w.dtype is _F32
            and all(v is None or v.dtype is _F32 for v in vectors)):
        raise TypeError(f"dwconv's kernel takes fp32 inputs; got x "
                        f"{x.dtype}, w {w.dtype}, b and bn "
                        f"{[None if v is None else v.dtype for v in vectors]}")
    pl, pr, pt, pb = pads
    k = w.shape[-1] if w.dim() == 4 else 0
    ok = (x.dim() == 4 and x.is_contiguous() and x.shape[-1] % 4 == 0
          and x.numel() <= MAX_ELEMENTS
          and (x.is_meta or x.data_ptr() % 16 == 0)
          and w.dim() == 4 and k in KERNEL_SIZES
          and tuple(w.shape) == (x.shape[-1], 1, k, k) and w.is_contiguous()
          and w.device == x.device
          and all(v is None or (tuple(v.shape) == (x.shape[-1],)
                                and v.is_contiguous()
                                and v.device == x.device) for v in vectors)
          and stride in STRIDES and all(0 <= p < k for p in pads))
    if ok:
        oh = (x.shape[1] + pt + pb - k) // stride + 1
        ow = (x.shape[2] + pl + pr - k) // stride + 1
        ok = oh > 0 and ow > 0 and x.shape[0] * oh * ow * x.shape[-1] <= (
            MAX_ELEMENTS)
    if not ok:
        got = [(name, tuple(t.shape), str(t.device), t.is_contiguous())
               for name, t in zip(("x", "w", "b", "mean", "var", "gamma",
                                   "beta"), (x, w) + vectors)
               if t is not None]
        raise ValueError(
            f"dwconv's kernel takes contiguous x (N, H, W, C) on 16 bytes "
            f"with C % 4 == 0, w (C, 1, k, k) with k in {KERNEL_SIZES}, b "
            f"and each of bn None or contiguous (C,), all on x's device, "
            f"stride in {STRIDES}, pads in [0, k), a non-empty output and "
            f"fewer than 2^31 elements in x and y; got (name, shape, "
            f"device, contiguous) {got}, stride {stride}, pads {pads}")
    return oh, ow


def dwconv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1,
           pads: Tuple[int, int, int, int] = (0, 0, 0, 0),
           bn: Optional[BnVectors] = None,
           act: Optional[str] = None) -> torch.Tensor:
    """x: (N, H, W, C); w: (C, 1, k, k); b: (C,) or None; pads: (left,
    right, top, bottom); bn: (mean, var, gamma, beta), each (C,), or None;
    act: None, "relu" or "relu6", with ``bn`` only -> y (N, OH, OW, C),
    contiguous."""
    code = ACT_CODES.get(act)
    if code is None or (bn is None and act is not None):
        raise ValueError(f"dwconv takes act None, or one of "
                         f"{sorted(EPILOGUE_ACTS)} with bn; got act {act!r}"
                         f" and {'no' if bn is None else 'a'} bn")
    if x.is_cpu:
        return dwconv_ref(x, w, b, stride, pads, bn, act)
    if not (x.is_cuda or x.is_meta):
        raise ValueError(f"dwconv runs on CUDA, CPU or meta tensors, not "
                         f"{x.device}")
    oh, ow = _check(x, w, b, stride, pads, bn)
    _build.refuse_grad("dwconv", x, w, b, *(bn or ()))
    n, h, wd, c = x.shape
    k = w.shape[-1]
    y = x.new_empty((n, oh, ow, c))
    _build.report_cost("dwconv", dwconv_cost, x, k, oh, ow, b is not None,
                       bn is not None, act)
    if x.is_meta:
        return y
    fn, raw_stream = _kernel()
    dev = x.get_device()
    ptrs = (None,) * 4 if bn is None else tuple(v.data_ptr() for v in bn)
    err = fn(x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
             y.data_ptr(), *ptrs, code, n, h, wd, c, oh, ow, k, stride,
             pads[2], pads[0], dev, raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"dwconv kernel launch failed: CUDA error {err}")
    _build.count_launch("dwconv", x.device)
    if bn is not None:
        _build.count_launch("dwconv.bn", x.device)
    return y


@functools.cache
def _kernel():
    """The bound C function, and the current raw stream of a card by its
    index."""
    fn = _build.load("dwconv").dwconv_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, torch._C._cuda_getCurrentRawStream
