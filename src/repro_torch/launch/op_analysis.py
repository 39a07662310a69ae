"""Counted cost of a step, the counterpart of ``repro/launch/hlo_analysis.py``
and ``repro/launch/collectives.py``.

The reference parses XLA's optimized HLO and evaluates it bottom up,
scaling while-loop bodies by their trip counts.  The port has no HLO: it
runs the step eagerly, so :func:`analyze` runs ``fn`` under a
:class:`~torch.utils._python_dispatch.TorchDispatchMode` that sees every
aten op it issues, the backward's and the remat's recomputes included
(the autograd engine carries the mode to its threads).  An eager loop is
counted at every trip, as the reference scales a while body by its trip
count.  Three things are counted:

* **FLOPs**: each aten op's formula in ``torch.utils.flop_counter``'s
  registry (mm, addmm, bmm, baddbmm, convolution and their kin), the
  reference's rule of 2 * prod(result) * contracting size for ``dot`` and
  ``convolution``; an op that has a decomposition is counted through
  it, as ``FlopCounterMode`` does.  The hand-written
  kernels are called through :mod:`ctypes`, out of the dispatcher's
  sight, so each wrapper reports its kernel's cost function instead
  (``kernels/_build.report_cost``); :attr:`CostTotals.kernels` holds them
  a kernel, and ``flops`` is the sum of both.  :attr:`CostTotals.aten_flops`
  is the aten part alone, what ``FlopCounterMode`` sees: the counterpart
  of the reference's ``hlo_flops_raw_cost_analysis``, which misses the
  while-loop trips as ``FlopCounterMode`` misses the hand kernels.
* **Bytes**: the traffic of eager execution, one launch per op: every op
  that moves data reads each tensor operand once and writes each result
  once (an ``out=`` argument is counted as the result it is).  A view or
  metadata op (every result an alias of an input, by the schema's alias
  annotations) and an allocation (``empty``) move nothing.  The
  reference instead models a TPU's fusion optimistically (elementwise
  producers fused into their consumers), so the two bytes models differ
  on purpose: this one is what the eager program moves.
* **Collectives**: one card runs none.  ``coll_*`` are 0 over the
  reference's five kinds; there is no HLO text to parse, so the
  reference's parser is not ported.

On ``meta`` tensors the step runs without data: the aten ops give their
shapes, and each kernel wrapper returns its outputs' shapes and reports
its cost without launching (so the count of a full-size step needs no
card and no memory).  On the CPU the kernels' plain versions run, and
their ops are counted as aten ops.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels import _build

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
# ops that read no tensor data: shape and layout queries (those
# FlopCounterMode passes over) and allocations that write nothing
_NO_TRAFFIC = {
    _aten.sym_is_contiguous.default, _aten.is_contiguous.default,
    _aten.is_contiguous.memory_format, _aten.is_strides_like_format.default,
    _aten.is_non_overlapping_and_dense.default, _aten.size.default,
    _aten.sym_size.default, _aten.stride.default, _aten.sym_stride.default,
    _aten.storage_offset.default, _aten.sym_storage_offset.default,
    _aten.numel.default, _aten.sym_numel.default, _aten.dim.default,
    torch.ops.prim.layout.default, torch.ops.prim.device.default,
    _aten.empty.memory_format, _aten.empty_like.default,
    _aten.empty_strided.default, _aten.new_empty.default,
    _aten.new_empty_strided.default,
    # a view whose schema does not say so
    _aten._unsafe_view.default,
}


def _is_view(func) -> bool:
    """Every result an alias of an input that the op does not write."""
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in rets)


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_flatten(tree)[0]
               if isinstance(x, torch.Tensor))


def _zeros() -> Dict[str, float]:
    return {k: 0.0 for k in COLLECTIVES}


@dataclasses.dataclass
class CostTotals:
    """The reference's fields (``hlo_analysis.CostTotals``), and the port's:
    ``aten_flops`` (the FLOPs of the aten ops alone), ``kernels`` (each
    hand kernel's calls, FLOPs and bytes: ``{"launches", "flops",
    "bytes"}``; on ``meta`` the launches the step would make) and ``ops``
    (each aten op's ``{"calls", "flops", "bytes"}``, the ops that move
    data or compute)."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: Optional[Dict[str, float]] = None
    coll_counts: Optional[Dict[str, float]] = None
    aten_flops: float = 0.0
    kernels: Optional[Dict[str, Dict[str, float]]] = None
    ops: Optional[Dict[str, Dict[str, float]]] = None

    def __add__(self, o: "CostTotals") -> "CostTotals":
        def merge(a, b):
            out = {key: dict(val) for key, val in (a or {}).items()}
            for key, val in (b or {}).items():
                row = out.setdefault(key, dict.fromkeys(val, 0.0))
                for field, x in val.items():
                    row[field] = row.get(field, 0.0) + x
            return out
        return CostTotals(
            self.flops + o.flops, self.hbm_bytes + o.hbm_bytes,
            self.coll_bytes + o.coll_bytes,
            {k: (self.coll_by_kind or {}).get(k, 0.0)
             + (o.coll_by_kind or {}).get(k, 0.0) for k in COLLECTIVES},
            {k: (self.coll_counts or {}).get(k, 0.0)
             + (o.coll_counts or {}).get(k, 0.0) for k in COLLECTIVES},
            self.aten_flops + o.aten_flops, merge(self.kernels, o.kernels),
            merge(self.ops, o.ops))

    def scaled(self, f: float) -> "CostTotals":
        def scale(table):
            return {key: {field: x * f for field, x in val.items()}
                    for key, val in (table or {}).items()}
        return CostTotals(
            self.flops * f, self.hbm_bytes * f, self.coll_bytes * f,
            {k: v * f for k, v in (self.coll_by_kind or {}).items()},
            {k: v * f for k, v in (self.coll_counts or {}).items()},
            self.aten_flops * f, scale(self.kernels), scale(self.ops))


class _Counter(TorchDispatchMode):
    """Adds each aten op's FLOPs and bytes, and each kernel call's
    reported cost, into one :class:`CostTotals`."""

    def __init__(self):
        super().__init__()
        self.lock = threading.Lock()
        self.totals = CostTotals(coll_by_kind=_zeros(),
                                 coll_counts=_zeros(), kernels={}, ops={})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _NO_TRAFFIC:
            return func(*args, **kwargs)
        # as FlopCounterMode: an op that has a decomposition (a
        # CompositeImplicitAutograd kernel) is counted through it
        with self:
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        self._add(func, args, kwargs, out)
        return out

    def _add(self, func, args, kwargs, out) -> None:
        formula = flop_registry.get(func._overloadpacket)
        flops = (float(formula(*args, **kwargs, out_val=out))
                 if formula is not None else 0.0)
        if _is_view(func):
            nbytes = 0
        else:
            nbytes = _nbytes(out)
            for i, arg in enumerate(func._schema.arguments):
                info = arg.alias_info
                if arg.kwarg_only and info is not None and info.is_write:
                    continue        # an out= argument: counted as the result
                nbytes += _nbytes(args[i] if i < len(args)
                                  else kwargs.get(arg.name))
        if not flops and not nbytes:
            return
        with self.lock:
            t = self.totals
            t.flops += flops
            t.aten_flops += flops
            t.hbm_bytes += nbytes
            row = t.ops.setdefault(str(func), {"calls": 0, "flops": 0.0,
                                               "bytes": 0.0})
            row["calls"] += 1
            row["flops"] += flops
            row["bytes"] += nbytes

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        with self.lock:
            t = self.totals
            t.flops += flops
            t.hbm_bytes += nbytes
            row = t.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                              "bytes": 0.0})
            row["launches"] += 1
            row["flops"] += flops
            row["bytes"] += nbytes


def counted(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` run under the counter -> (its result, the
    :class:`CostTotals` of the run)."""
    counter = _Counter()
    with _build.cost_sink(counter.kernel), counter:
        result = fn(*args, **kwargs)
    return result, counter.totals


def analyze(fn: Callable, *args, **kwargs) -> CostTotals:
    """The :class:`CostTotals` of one run of ``fn(*args, **kwargs)``."""
    return counted(fn, *args, **kwargs)[1]


def same_count(a: CostTotals, b: CostTotals) -> bool:
    """Whether two counts agree op for op: every aten op's calls, FLOPs
    and bytes and every kernel's launches, FLOPs and bytes."""
    return a.ops == b.ops and a.kernels == b.kernels

