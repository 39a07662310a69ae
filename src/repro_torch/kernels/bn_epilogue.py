"""Inference BatchNorm with the add and activation after it: the wrapper
around ``csrc/bn_epilogue.cu``.

``bn_epilogue(x, mean, var, gamma, beta, r, act)`` computes
``act(((x - mean) * rsqrt(var + 1e-3)) * gamma + beta [+ r])`` over the
last axis of x: the CNN forward's ``bn`` node, and the ``add`` and ``act``
nodes that :class:`~repro_torch.models.layers.GraphModel` runs with it.
It replaces no TPU kernel (the reference leaves this fusion to XLA).
``act`` is None, "relu" or "relu6"; ``r`` None or a tensor of x's shape.

CUDA tensors launch the kernel, one counted launch a call
(``bn_epilogue``) on the current stream of x's card; its output equals the
plain ops bit for bit on finite inputs, up to the sign of a zero.  CPU
tensors take the plain version
:func:`~repro_torch.kernels.ref.bn_epilogue_ref`, the CNN forward's ops in
their order.  Any other case raises: inputs that are not fp32
(``TypeError``); x or r not contiguous, per-channel vectors not of x's
last dimension on x's card, r not of x's shape, or 2^31 elements or more
(``ValueError``); and an input that requires grad while autograd records
(``RuntimeError``: the kernel has no backward; ``GraphModel`` runs the
plain ops itself there).  ``meta`` tensors take the kernel's route up to
the launch and return the output's shape.  Every call on the card or on
``meta`` reports :func:`epilogue_cost` to ``_build.report_cost``.

The wrapper is on the host's path once a BN, so it checks only device,
dtype, contiguity and sizes, and binds the C function once.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .ref import EPILOGUE_ACTS, bn_epilogue_ref

ACT_CODES = {None: 0, "relu": 1, "relu6": 2}
_F32 = torch.float32
MAX_ELEMENTS = 2 ** 31 - 1    # the kernel indexes in 32 bits


def epilogue_cost(x: torch.Tensor, residual: bool, act: Optional[str]):
    """(FLOPs, bytes) of one call: sub, mul, mul and add an element, one
    more with a residual and one with an activation; x read and y written
    once in fp32, r read once, the four per-channel vectors read once."""
    n, c = x.numel(), x.shape[-1]
    ops = 4 + residual + (act is not None)
    return ops * n, 4 * n * (2 + residual) + 16 * c


def _check(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
           gamma: torch.Tensor, beta: torch.Tensor,
           r: Optional[torch.Tensor]) -> None:
    """Raise unless the kernel takes these inputs: all fp32 and contiguous
    on x's card, the per-channel vectors of x's last dimension, r of x's
    shape, fewer than 2^31 elements."""
    if not (x.dtype is _F32 and mean.dtype is _F32 and var.dtype is _F32
            and gamma.dtype is _F32 and beta.dtype is _F32
            and (r is None or r.dtype is _F32)):
        raise TypeError(f"bn_epilogue's kernel takes fp32 inputs; got x "
                        f"{x.dtype}, mean/var/gamma/beta {mean.dtype}/"
                        f"{var.dtype}/{gamma.dtype}/{beta.dtype}, r "
                        f"{None if r is None else r.dtype}")
    c, dev = x.shape[-1], x.get_device()
    if not (x.is_contiguous() and x.numel() <= MAX_ELEMENTS
            and mean.numel() == var.numel() == gamma.numel()
            == beta.numel() == c
            and mean.is_contiguous() and var.is_contiguous()
            and gamma.is_contiguous() and beta.is_contiguous()
            and mean.get_device() == var.get_device() == gamma.get_device()
            == beta.get_device() == dev
            and not (mean.is_cpu or var.is_cpu or gamma.is_cpu
                     or beta.is_cpu)
            and (r is None or (r.is_contiguous() and r.shape == x.shape
                               and r.get_device() == dev
                               and not r.is_cpu))):
        got = [(name, tuple(t.shape), str(t.device), t.is_contiguous())
               for name, t in (("x", x), ("mean", mean), ("var", var),
                               ("gamma", gamma), ("beta", beta), ("r", r))
               if t is not None]
        raise ValueError(
            f"bn_epilogue's kernel takes contiguous x (..., C) of fewer "
            f"than 2^31 elements, mean/var/gamma/beta of C on x's device "
            f"and r None or contiguous of x's shape there; got (name, "
            f"shape, device, contiguous) {got}")


def bn_epilogue(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                gamma: torch.Tensor, beta: torch.Tensor,
                r: Optional[torch.Tensor] = None,
                act: Optional[str] = None) -> torch.Tensor:
    """x: (..., C); mean, var, gamma, beta: (C,); r: x's shape or None ->
    y of x's shape."""
    code = ACT_CODES.get(act)
    if code is None:
        raise ValueError(f"bn_epilogue takes act None or one of "
                         f"{sorted(EPILOGUE_ACTS)}, not {act!r}")
    if x.is_cpu:
        return bn_epilogue_ref(x, mean, var, gamma, beta, r, act)
    if not (x.is_cuda or x.is_meta):
        raise ValueError(f"bn_epilogue runs on CUDA, CPU or meta tensors, "
                         f"not {x.device}")
    _check(x, mean, var, gamma, beta, r)
    _build.refuse_grad("bn_epilogue", x, r, mean, var, gamma, beta)
    y = torch.empty_like(x)
    _build.report_cost("bn_epilogue", epilogue_cost, x, r is not None, act)
    if x.is_meta:
        return y
    fn, raw_stream = _kernel()
    dev = x.get_device()
    err = fn(x.data_ptr(), None if r is None else r.data_ptr(), y.data_ptr(),
             mean.data_ptr(), var.data_ptr(), gamma.data_ptr(),
             beta.data_ptr(), x.numel(), x.shape[-1], code, dev,
             raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"bn_epilogue kernel launch failed: CUDA error "
                           f"{err}")
    _build.count_launch("bn_epilogue", x.device)
    return y


@functools.cache
def _kernel():
    """The bound C function, and the current raw stream of a card by its
    index."""
    fn = _build.load("bn_epilogue").bn_epilogue_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, torch._C._cuda_getCurrentRawStream
