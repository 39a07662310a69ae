"""int8 matrix product: the wrapper around ``csrc/matmul_qi8.cu``.

``matmul_qi8(x, w)`` computes the function of the TPU kernel
``repro/kernels/matmul_qi8.py``: x ``(M, K)`` int8 times w ``(K, N)`` int8
-> ``(M, N)`` int32, exact.  It takes any (M, K, N), as the reference's
public wrapper (``repro/kernels/ops.py`` ``matmul_qi8``) does off the TPU:
the Pallas function's ``block=`` argument and its assert that the shape
divides the block are the TPU's (8, 128) / MXU tiling, and the CUDA kernel
masks its ragged edge tiles itself (zero-fill on load, so any K is exact).
CUDA tensors launch the hand-written kernel (s8 tensor cores; row-major,
contiguous); CPU tensors take the plain version
:func:`~repro_torch.kernels.ref.matmul_qi8_ref`.  Any other case raises.
Where the output tiles would not fill the card, :func:`split_k` cuts K
into slices that add into a zeroed output with exact int32 atomics, still
one launch.  The scaled int8 API (``quantize_int8``,
``matmul_qi8`` with scales, ``quantized_dense``) is :mod:`.quant`.

``meta`` tensors take the kernel's route up to the launch (split as on an
H100's :data:`SMS`): the output comes back with its shape and nothing
runs.  Every call on the card or on ``meta`` reports :func:`qi8_cost` to
``_build.report_cost``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import matmul_qi8_ref

_MAX_ROWS = 65535 * 64          # the grid's y extent x the kernel's rows
SMS = 132                       # streaming multiprocessors of an H100 SXM
K_STEP = 32                     # K of one m16n8k32 step: slices are multiples
_BN = 64                        # output columns a block


def block_rows(m: int) -> int:
    """Output rows of the kernel's tile: 16 for M <= 16, else 64."""
    return 16 if m <= 16 else 64


def split_k(m: int, k: int, n: int, sms: int = SMS) -> tuple:
    """``(splits, k_chunk)``: K cut into ``splits`` slices of ``k_chunk``
    (a multiple of :data:`K_STEP`; the last slice ends at K), enough that
    the output tiles times the slices fill ``sms`` blocks where K allows.
    One slice when the tiles alone fill the card."""
    steps = max(1, -(-k // K_STEP))
    tiles = max(1, -(-m // block_rows(m)) * -(-n // _BN))
    want = min(steps, -(-sms // tiles)) if tiles < sms else 1
    chunk_steps = -(-steps // want)
    return -(-steps // chunk_steps), chunk_steps * K_STEP


def qi8_cost(m: int, k: int, n: int):
    """(operations, bytes) of an (M, K) x (K, N) product: 2*M*N*K int8
    operations; x and w read and the int32 output written once."""
    return 2 * m * n * k, m * k + k * n + 4 * m * n


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_qi8 wants x (M,K) and w (K,N); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"matmul_qi8 takes int8 x and w; got {x.dtype}, "
                        f"{w.dtype}")
    if x.device != w.device:
        raise ValueError(f"matmul_qi8 inputs on different devices: "
                         f"{x.device}, {w.device}")


def matmul_qi8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M, K) int8; w: (K, N) int8 -> (M, N) int32."""
    _check(x, w)
    if x.device.type == "cpu":
        return matmul_qi8_ref(x, w)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"matmul_qi8 runs on CUDA, CPU or meta tensors, not "
                         f"{x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("matmul_qi8 kernel needs row-major contiguous x "
                         "and w")
    (m, k), n = x.shape, w.shape[1]
    if m > _MAX_ROWS:
        raise ValueError(f"matmul_qi8 kernel takes at most {_MAX_ROWS} "
                         f"rows, got {m}")
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=torch.int32, device=x.device)
    splits, k_chunk = split_k(
        m, k, n, SMS if x.device.type == "meta" else
        torch.cuda.get_device_properties(x.device).multi_processor_count)
    # the slices add into zeros (a memset); one slice stores its tiles
    alloc = torch.zeros if splits > 1 else torch.empty
    out = alloc((m, n), dtype=torch.int32, device=x.device)
    _build.report_cost("matmul_qi8", qi8_cost, m, k, n)
    if x.device.type == "meta":
        return out
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                 k_chunk, splits, stream)
    if err != 0:
        raise RuntimeError(f"matmul_qi8 kernel launch failed: CUDA error "
                           f"{err}")
    _build.count_launch("matmul_qi8", x.device)
    return out


@functools.cache
def _kernel():
    fn = _build.load("matmul_qi8").matmul_qi8_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
