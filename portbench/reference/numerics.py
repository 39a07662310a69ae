"""The precision a reference computes in.

``fp32`` is float32 with TF32 off (what the configurations state).
``tf32`` is the control, the nearest precision below: on a card the
matrix products and convolutions run in TF32; on the CPU, which has no
TF32, their operands are rounded to TF32's 10-bit mantissa first (how a
test at a small size sees the control).  ``fp64`` computes in float64: a
witness of what float32's own rounding does.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "tf32", "fp64")
DTYPES = {"fp32": torch.float32, "tf32": torch.float32,
          "fp64": torch.float64}


@contextlib.contextmanager
def precision(name: str):
    """Set the card's TF32 switches for ``name`` and restore them."""
    if name not in PRECISIONS:
        raise ValueError(f"precision {name!r}: one of {PRECISIONS}")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to nearest even at TF32's 10 mantissa
    bits."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    bits = bits + 0xFFF + ((bits >> 13) & 1)
    bits = bits & ~0x1FFF
    return bits.to(torch.int32).view(torch.float32).view(x.shape)


class Ops:
    """The products a reference makes, in one precision."""

    def __init__(self, name: str = "fp32"):
        if name not in PRECISIONS:
            raise ValueError(f"precision {name!r}: one of {PRECISIONS}")
        self.name = name
        self.dtype = DTYPES[name]

    def _in(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32" and t.device.type != "cuda":
            return round_tf32(t)
        return t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._in(a) @ self._in(b)

    def conv(self, x: torch.Tensor, w: torch.Tensor, b, stride: int
             ) -> torch.Tensor:
        return F.conv2d(self._in(x), self._in(w), b, stride=stride)
