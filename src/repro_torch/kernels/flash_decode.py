"""Flash-decode: the wrapper around ``csrc/flash_decode.cu``.

``flash_decode(q, k_cache, v_cache, cache_len)`` computes the function of
the TPU kernel ``repro/kernels/flash_decode.py``: one query token per
(batch row, q head), q ``(B, Hq, D)``, k/v caches ``(B, Hkv, T, D)``, GQA,
cache positions ``[0, len)`` valid, fp32 online softmax, output in q's
dtype.  ``cache_len`` is an int or a ``(B,)`` per-slot length; a length of
0 gives zeros and a length above T means all T positions.  CUDA tensors
launch the hand-written kernel; CPU tensors take the plain version
:func:`~repro_torch.kernels.ref.flash_decode_ref`.  Any other case raises.

The kernel takes element strides for the batch, head and sequence axes, so
the caches may be ``(B, Hkv, T, D)`` views of the decode engine's
``(slots, T, Hkv, D)`` layer caches, read in place; the head dim must be
contiguous and every cache row 16-byte aligned (it is loaded 16 bytes a
lane).  bf16 runs on the tensor cores, one block serving up to 16 q heads
of one kv head; fp32 on CUDA cores, up to 8 (4 at head dim 96).  A ``(B,)`` length tensor is
read by the kernel from device memory, so nothing on the host waits for
it.

``meta`` tensors take the kernel's route up to the launch: the output
comes back with its shape and dtype and nothing runs.  Every call on the
card or on ``meta`` reports :func:`decode_cost` to
``_build.report_cost``.

The split plan is host arithmetic, pinned by the CPU tests:
:func:`split_plan` picks the number of splits of every row from the card's
SM count, and :func:`split_length` (computed again in the kernel) cuts a
row's valid length, not T, into that many splits of whole key tiles.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import decode_lengths, flash_decode_ref

HEAD_DIMS = (16, 32, 64, 96, 128, 256)
KEY_TILE = 16                 # keys a warp's tile; splits are multiples
WARPS = 4                     # warps a block, each on its own tiles
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def split_plan(b: int, hkv: int, t: int, d: int, n_sm: int) -> int:
    """Splits of every row: as many as fill the card's resident blocks in
    one wave (two blocks an SM below head dim 256, whose bf16 block holds
    211 KB of shared memory, one above), but no more than leave each split
    one key tile per warp of a cache of ``t`` positions.  A block more
    than the card holds at once would run in a tail wave of its own."""
    resident = n_sm * (1 if d >= 256 else 2)
    fill = resident // max(1, b * hkv)
    return max(1, min(fill, t // (KEY_TILE * WARPS)))


def split_length(length: int, nsplit: int) -> int:
    """Positions each split of a row of ``length`` valid positions covers:
    ``length / nsplit`` rounded up to whole key tiles, so split ``i`` covers
    ``[i * n, min((i + 1) * n, length))`` and every split of a row carries
    about the same work.  The kernel computes the same per row."""
    per = -(-length // nsplit)
    return -(-per // KEY_TILE) * KEY_TILE


def decode_cost(q: torch.Tensor, k: torch.Tensor, positions: int):
    """(FLOPs, bytes) of one call over ``positions`` valid cache positions
    summed over the batch rows: 4*D flops per (q head, position); q read,
    the output written and each valid K and V row read once."""
    b, hq, d = q.shape
    hkv = k.shape[1]
    flops = 4 * d * hq * positions
    nbytes = (2 * q.numel() + 2 * hkv * positions * d) * q.element_size()
    return flops, nbytes


def valid_positions(cache_len, b: int, t: int) -> int:
    """The valid cache positions of a call, summed over its ``b`` rows:
    each row's length clamped to [0, T].  A length tensor is read on the
    host; on ``meta`` it has no values, and every row counts T."""
    if isinstance(cache_len, int):
        return b * min(max(cache_len, 0), t)
    if cache_len.device.type == "meta":
        return b * t
    lens = torch.as_tensor(cache_len).reshape(-1).expand(b)
    return int(lens.clamp(0, t).sum())


def _cost(q, k, cache_len):
    return decode_cost(q, k, valid_positions(cache_len, q.shape[0],
                                             k.shape[2]))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_decode wants q (B,Hq,D) and k/v caches "
                         f"(B,Hkv,T,D) of one shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, d = q.shape
    bk, hkv, _, dk = k.shape
    if bk != b or dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_decode: batch and head dim must match and "
                         f"Hq must be a multiple of Hkv; got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_decode takes one dtype of {list(_DTYPES)}; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_decode inputs on different devices: "
                         f"{q.device}, {k.device}, {v.device}")


def _check_kernel_layout(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> None:
    d = q.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_decode kernel takes head dims {HEAD_DIMS}, "
                         f"got {d}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash_decode needs a contiguous head dim "
                         "(stride 1 on the last axis)")
    size = k.element_size()
    for x in (k, v):
        if x.data_ptr() % 16 or any(st * size % 16 for st in x.stride()[:3]):
            raise ValueError("flash_decode needs 16-byte aligned cache rows "
                             "(base pointer and batch/head/seq strides)")


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cache_len) -> torch.Tensor:
    """q: (B, Hq, D); k/v caches: (B, Hkv, T, D); cache_len: an int or a
    (B,) integer tensor -> (B, Hq, D)."""
    _check(q, k_cache, v_cache)
    if q.device.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, cache_len)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_decode runs on CUDA, CPU or meta tensors, "
                         f"not {q.device}")
    _check_kernel_layout(q, k_cache, v_cache)
    _build.refuse_grad("flash_decode", q, k_cache, v_cache)
    b, hq, d = q.shape
    hkv, t = k_cache.shape[1], k_cache.shape[2]
    if isinstance(cache_len, int):
        len_ptr, scalar = None, cache_len
    else:
        lens = decode_lengths(cache_len, b, q.device).contiguous()
        len_ptr, scalar = lens.data_ptr(), 0
    _build.report_cost("flash_decode", _cost, q, k_cache, cache_len)
    if q.device.type == "meta":
        return torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    nsplit = split_plan(b, hkv, t, d, _sm_count(q.device.index))
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    part_acc = part_ml = None
    if nsplit > 1:
        part_acc = torch.empty((b, hq, nsplit, d), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((b, hq, nsplit, 2), dtype=torch.float32,
                              device=q.device)
    strides = (ctypes.c_longlong * 10)(
        *q.stride()[:2], *k_cache.stride()[:3], *v_cache.stride()[:3],
        *out.stride()[:2])
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 out.data_ptr(),
                 None if part_acc is None else part_acc.data_ptr(),
                 None if part_ml is None else part_ml.data_ptr(),
                 len_ptr, scalar, _DTYPES[q.dtype], b, hq, hkv, t, d,
                 nsplit, strides, d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{err}")
    _build.count_launch("flash_decode", q.device)
    return out


@functools.cache
def _kernel():
    fn = _build.load("flash_decode").flash_decode_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
