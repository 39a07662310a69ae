"""O(1) segment-cost engine: the fast path under the planner and refiner.

The paper's plan search evaluates thousands of candidate segments.  The seed
implementation re-walked every layer of the graph per candidate (and rebuilt
the cut-crossing activation array twice per ``segment_time`` call), making
``plan()`` quadratic-ish in model depth.  :class:`SegmentCostEngine`
precomputes, once per (graph, spec, cost source):

* per-depth prefix sums of params / MACs / weight bytes, so any contiguous
  segment's totals are two array reads;
* the flat layer order (depth-major, insertion order within a depth — the
  exact order the greedy whole-layer placement of paper §4.2 visits) plus a
  prefix-sum over per-layer weight bytes, so the greedy *spill point* of a
  segment is a binary search instead of a scan;
* a sparse table over the per-depth maximum single-layer activation, so the
  activation-reserve term of the capacity formula is an O(1) range-max;
* the cut-crossing activation bytes array (stage I/O term), computed once.

With these, ``segment_time`` is O(1) and the memory split is O(log L) plus a
short tail scan only when the segment actually spills (greedy placement may
still fit later-but-smaller layers after the first rejection, so the tail is
walked layer-by-layer to stay bit-identical with the naive placement).

Cost sources
------------
Where the per-depth numbers come from is pluggable: the engine materializes
a :class:`~repro.profiling.sources.CostSource` (duck-typed — this module
stays import-light) into its prefix arrays once.  Without a source — or
with the :class:`~repro.profiling.sources.AnalyticCostSource` — the arrays
are the graph's own cached lists and ``segment_time`` evaluates the
closed-form expression over segment sums, in the same float order as the
naive ``EdgeTPUModel`` paths: results are **bit-identical**, which
tests/test_cost_engine.py asserts over random segments of real Table-1
models.  A measured source (trace / calibrated) instead supplies per-depth
*times*; the engine prefix-sums them, so a segment's compute time is still
two array reads, and adds the memory-model transfer terms (host-resident
weight streaming, spill overhead, stage I/O) from the device spec exactly
as before — measured compute composed with modeled transfers, the paper's
profile-then-model pipeline.
"""
from __future__ import annotations

import bisect
import itertools
from typing import Dict, List, Sequence, Tuple

from .costs import greedy_layer_placement, greedy_layer_split, \
    weight_capacity_bytes
from .graph import LayerGraph


def _prefix(vals: Sequence[int]) -> List[int]:
    return list(itertools.accumulate(vals, initial=0))


def _fprefix(vals: Sequence[float]) -> List[float]:
    return list(itertools.accumulate(vals, initial=0.0))


class SegmentCostEngine:
    """Precomputed range queries over one :class:`LayerGraph` + device spec.

    ``spec`` is duck-typed (an :class:`~repro_torch.core.edge_tpu_model.EdgeTPUSpec`
    in practice) to keep this module free of circular imports; so is
    ``cost_source`` (anything with ``materialize(graph, spec) ->
    DepthCosts``; ``None`` means the built-in analytic arithmetic).
    """

    def __init__(self, graph: LayerGraph, spec, cost_source=None):
        self.graph = graph
        self.spec = spec
        self.cost_source = cost_source
        levels = graph.levels()
        self.depth = len(levels)
        nodes = graph.nodes

        # flat layer order = greedy placement order (depth-major)
        self._flat: List[str] = [n for lvl in levels for n in lvl]
        self._level_start: List[int] = [0] * (self.depth + 1)
        pos = 0
        for d, lvl in enumerate(levels):
            self._level_start[d] = pos
            pos += len(lvl)
        self._level_start[self.depth] = pos
        self._layer_bytes: List[int] = [nodes[n].bytes for n in self._flat]
        self._layer_prefix: List[int] = _prefix(self._layer_bytes)

        # sparse table over per-depth max single-layer activation
        amax = [max((nodes[n].out_bytes for n in lvl), default=0)
                for lvl in levels]
        self._build_sparse(amax)

        self._materialize(spec)
        self._split_cache: Dict[Tuple[int, int], Tuple[int, int]] = {}

    def _materialize(self, spec) -> None:
        """Fill the per-depth prefix arrays from the cost source (or the
        graph directly when no source is set — same numbers, same list
        objects, zero overhead)."""
        src = self.cost_source
        if src is None:
            graph = self.graph
            params = graph.params_per_depth()
            macs = graph.macs_per_depth()
            weight_bytes = graph.bytes_per_depth()
            cut_bytes = graph.out_bytes_per_depth()
            time_s = wload_s = state_bytes = None
        else:
            dc = src.materialize(self.graph, spec)
            params, macs = dc.params, dc.macs
            weight_bytes, cut_bytes = dc.weight_bytes, dc.cut_bytes
            time_s, wload_s = dc.time_s, dc.weight_load_s
            state_bytes = getattr(dc, "state_bytes", None)
        self._params_prefix = _prefix(params)
        self._macs_prefix = _prefix(macs)
        self._bytes_prefix = _prefix(weight_bytes)
        self._cut_bytes = list(cut_bytes)
        # measured mode: per-depth times prefix-summed for O(1) segments
        self._time_prefix = None if time_s is None else _fprefix(time_s)
        self._wload_prefix = (None if wload_s is None
                              else _fprefix(wload_s))
        # decode mode: per-depth per-sequence state (KV / recurrent) bytes
        self._state_prefix = (None if state_bytes is None
                              else _prefix(state_bytes))

    @property
    def is_measured(self) -> bool:
        """True when segment compute times come from a trace-backed source
        instead of the closed-form analytic expression."""
        return self._time_prefix is not None

    @property
    def has_state_costs(self) -> bool:
        """True when the cost source supplies per-depth decode state bytes
        (KV cache / recurrent state) — the decode-placement regime."""
        return self._state_prefix is not None

    def with_spec(self, spec) -> "SegmentCostEngine":
        """An engine for the same graph under a different device spec.

        The graph-side precomputes (sparse table, flat layer order, layer
        prefix) are spec-independent, so the clone shares them by
        reference — per-stage device limits (heterogeneous topologies)
        cost O(1) per device class instead of another O(L) build.  Only
        the capacity/time queries see the new spec; a measured cost
        source re-materializes its per-depth times for the new device
        (O(d), still amortized once per device class).
        """
        clone = object.__new__(SegmentCostEngine)
        clone.__dict__.update(self.__dict__)
        clone.spec = spec
        clone._split_cache = {}          # capacity differs under the new spec
        if clone.cost_source is not None:
            clone._materialize(spec)     # device-dependent per-depth arrays
        return clone

    # -- sparse-table range max ---------------------------------------------
    def _build_sparse(self, vals: Sequence[int]) -> None:
        n = len(vals)
        log = [0] * (n + 1)
        for i in range(2, n + 1):
            log[i] = log[i // 2] + 1
        table = [list(vals)]
        k = 1
        while (1 << k) <= n:
            prev = table[-1]
            half = 1 << (k - 1)
            table.append([max(prev[i], prev[i + half])
                          for i in range(n - (1 << k) + 1)])
            k += 1
        self._log2 = log
        self._sparse = table

    def segment_max_activation(self, depth_lo: int, depth_hi: int) -> int:
        """Largest single-layer activation in the depth range — O(1)."""
        if depth_hi < depth_lo:
            return 0
        k = self._log2[depth_hi - depth_lo + 1]
        row = self._sparse[k]
        return max(row[depth_lo], row[depth_hi - (1 << k) + 1])

    # -- O(1) range sums -----------------------------------------------------
    def segment_params(self, depth_lo: int, depth_hi: int) -> int:
        return self._params_prefix[depth_hi + 1] - self._params_prefix[depth_lo]

    def segment_macs(self, depth_lo: int, depth_hi: int) -> int:
        return self._macs_prefix[depth_hi + 1] - self._macs_prefix[depth_lo]

    def segment_weight_bytes(self, depth_lo: int, depth_hi: int) -> int:
        return self._bytes_prefix[depth_hi + 1] - self._bytes_prefix[depth_lo]

    def segment_state_bytes(self, depth_lo: int, depth_hi: int) -> int:
        """Per-sequence decode state (KV cache / recurrent) bytes the
        segment pins on-device — 0 unless the cost source supplies a
        decode regime (:attr:`has_state_costs`)."""
        if self._state_prefix is None:
            return 0
        return (self._state_prefix[depth_hi + 1]
                - self._state_prefix[depth_lo])

    def depth_weight_bytes(self) -> List[int]:
        """Per-depth weight bytes as the cost source accounts them — the
        refinement reporter's multi-step move sizing reads these, so the
        refiner and the planner share one bytes model."""
        p = self._bytes_prefix
        return [p[d + 1] - p[d] for d in range(self.depth)]

    def cut_io_bytes(self, depth_lo: int, depth_hi: int) -> Tuple[int, int]:
        """(input, output) activation bytes crossing the segment boundaries."""
        in_b = self._cut_bytes[depth_lo - 1] if depth_lo > 0 else 0
        out_b = (self._cut_bytes[depth_hi]
                 if depth_hi < self.depth - 1 else 0)
        return in_b, out_b

    # -- memory (paper §4.2 greedy placement) --------------------------------
    def segment_capacity(self, depth_lo: int, depth_hi: int) -> int:
        """Weight capacity after the fixed + activation reserves."""
        spec = self.spec
        act = self.segment_max_activation(depth_lo, depth_hi)
        return weight_capacity_bytes(spec.onchip_bytes, spec.fixed_reserve,
                                     spec.act_reserve_factor, act)

    def segment_split(self, depth_lo: int, depth_hi: int) -> Tuple[int, int]:
        """(device_bytes, host_bytes) of the greedy whole-layer placement.

        Binary search over the weight-bytes prefix array finds the greedy
        spill point (the first rejected layer); only the tail after it is
        scanned, because already-rejected capacity never recovers but smaller
        later layers may still fit.
        """
        key = (depth_lo, depth_hi)
        hit = self._split_cache.get(key)
        if hit is not None:
            return hit
        a = self._level_start[depth_lo]
        b = self._level_start[depth_hi + 1]
        cap = self.segment_capacity(depth_lo, depth_hi)
        prefix = self._layer_prefix
        base = prefix[a]
        # largest m with sum(bytes of first m layers) <= cap
        idx = bisect.bisect_right(prefix, base + cap, a, b + 1) - 1
        if idx >= b:                      # everything fits on-device
            result = (prefix[b] - base, 0)
            self._split_cache[key] = result
            return result
        idx = max(idx, a)
        # tail: greedy continues per-layer from the already-placed prefix
        result = greedy_layer_split(self._layer_bytes[idx:b], cap,
                                    device0=prefix[idx] - base)
        self._split_cache[key] = result
        return result

    def segment_host_bytes(self, depth_lo: int, depth_hi: int) -> int:
        return self.segment_split(depth_lo, depth_hi)[1]

    def segment_placement(self, depth_lo: int, depth_hi: int
                          ) -> Tuple[int, int, Dict[str, str]]:
        """Full (device, host, {layer: placement}) report — O(segment)."""
        a = self._level_start[depth_lo]
        b = self._level_start[depth_hi + 1]
        cap = self.segment_capacity(depth_lo, depth_hi)
        return greedy_layer_placement(self._flat[a:b],
                                      self._layer_bytes[a:b], cap)

    # -- time ----------------------------------------------------------------
    def segment_weight_load_time(self, depth_lo: int, depth_hi: int) -> float:
        """Systolic-array weight-fill time of the segment — the stage-time
        term that does NOT amortize when a stage is replicated (every
        replica re-fills its array per inference it serves)."""
        if self._wload_prefix is not None:
            return (self._wload_prefix[depth_hi + 1]
                    - self._wload_prefix[depth_lo])
        weight_bytes = self.segment_weight_bytes(depth_lo, depth_hi)
        return weight_bytes / (self.spec.weight_load_gbps * 1e9)

    def segment_compute_time(self, depth_lo: int, depth_hi: int) -> float:
        """Compute + weight-load time only (no transfer terms): the term a
        measured cost source replaces."""
        if self._time_prefix is not None:
            return self._time_prefix[depth_hi + 1] - self._time_prefix[depth_lo]
        spec = self.spec
        macs = self.segment_macs(depth_lo, depth_hi)
        weight_bytes = self.segment_weight_bytes(depth_lo, depth_hi)
        return (macs / spec.macs_per_s
                + weight_bytes / (spec.weight_load_gbps * 1e9))

    def segment_time(self, depth_lo: int, depth_hi: int) -> float:
        """Per-inference latency of one segment on one TPU — O(1).

        Analytic mode: same expression (and float evaluation order) as the
        naive ``EdgeTPUModel.segment_time`` — systolic compute + weight
        load + host-resident weight streaming + spill overhead + stage I/O
        + per-inference overhead.  Measured mode: the compute+weight-load
        term is the prefix-summed per-depth source time; the transfer
        terms still come from the memory model.
        """
        spec = self.spec
        t_compute = self.segment_compute_time(depth_lo, depth_hi)
        host_bytes = self.segment_host_bytes(depth_lo, depth_hi)
        t_stream = host_bytes / (spec.pcie_gbps * 1e9)
        t_spill = spec.spill_event_overhead_s if host_bytes > 0 else 0.0
        in_bytes, out_bytes = self.cut_io_bytes(depth_lo, depth_hi)
        t_io = (in_bytes + out_bytes) / (spec.pcie_gbps * 1e9)
        return (t_compute + t_stream + t_spill + t_io
                + spec.per_inference_overhead_s)

    def depth_cost_ns(self) -> List[int]:
        """Integer per-depth compute cost in nanoseconds — the balance
        weights of the ``balanced_cost`` strategy.  Analytic mode keeps
        that strategy's historical expression exactly; measured mode uses
        the source's per-depth times."""
        if self._time_prefix is not None:
            tp = self._time_prefix
            return [int(1e9 * (tp[d + 1] - tp[d])) for d in range(self.depth)]
        spec = self.spec
        mp, bp = self._macs_prefix, self._bytes_prefix
        return [int(1e9 * ((mp[d + 1] - mp[d]) / spec.macs_per_s
                           + (bp[d + 1] - bp[d])
                           / (spec.weight_load_gbps * 1e9)))
                for d in range(self.depth)]

    def stage_times(self, cuts: Sequence[int]) -> List[float]:
        from .segmentation import segment_ranges
        return [self.segment_time(lo, hi)
                for lo, hi in segment_ranges(self.depth, cuts)]

    def max_stage_time(self, cuts: Sequence[int]) -> float:
        return max(self.stage_times(cuts))
