"""CostSource: the pluggable per-depth cost API behind the planner.

Every planning strategy prices candidate segments through a
:class:`~repro_torch.core.cost_engine.SegmentCostEngine`.  The engine used to
reach into ``LayerGraph``'s cost formulas directly — one hard-wired
analytic MACs/params model.  A :class:`CostSource` is the seam that
replaces it: a source materializes, once per (graph, device spec), the
per-depth arrays the engine's O(1) prefix-sum machinery consumes
(:class:`DepthCosts`), and answers per-depth point queries
(:meth:`CostSource.layer_time_s`, :meth:`CostSource.layer_params`,
activation / host-transfer bytes) for direct consumers.

Three implementations:

* :class:`AnalyticCostSource` — today's closed-form model.  It returns
  ``time_s=None``, telling the engine to keep its exact legacy arithmetic
  (segment MAC/byte sums divided by spec rates, in the same float order),
  so plans are **bit-identical** to the pre-CostSource planner — asserted
  over all 21 Table-1 models in tests/test_profiling.py.
* :class:`TraceCostSource` — measured per-depth times from a persisted
  :class:`~repro_torch.profiling.trace.ProfileTrace` (the paper's profile-based
  planning); unprofiled depths fall back to the analytic prediction.
* :class:`CalibratedCostSource` — the analytic model with its per-device
  coefficients re-fit against a trace by least squares
  (:mod:`repro_torch.profiling.calibrate`): keeps the analytic form (so it
  extrapolates structurally) but matches the measured magnitudes.

Device scaling: a trace measures ONE device.  When the engine prices a
different :class:`~repro_torch.core.topology.DeviceSpec` (heterogeneous
topologies), measured times scale by the ratio of the reference spec's MAC
rate to the target's — ``compute_scale=2`` halves measured times, exactly
as it doubles the analytic rate.  A reference device (scale 1.0) applies
no float op at all, keeping homogeneous plans bit-stable.

Spec syntax (``DeploymentSpec.cost_source``): ``"analytic"`` (default),
``"trace:<path>"``, ``"calibrated:<path>"`` — resolved by
:func:`resolve_cost_source`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from ..core.edge_tpu_model import EdgeTPUSpec
from ..core.graph import LayerGraph
from .calibrate import CalibrationFit, fit_trace
from .trace import ProfileTrace


@dataclasses.dataclass(frozen=True)
class DepthCosts:
    """Per-depth arrays a :class:`SegmentCostEngine` materializes once.

    ``time_s is None`` means "no measured times: use the closed-form
    analytic expression over the integer arrays" — the bit-identical
    legacy path.  When ``time_s`` is given, ``weight_load_s`` must be too
    (the non-amortizing replication term).

    ``state_bytes`` is the decode regime's third axis (ISSUE 10): per-depth
    *per-sequence* steady-state bytes a depth level pins on-device while a
    sequence is in flight — KV cache for attention blocks (a function of
    context length), O(1) recurrent state for rwkv6/rglru blocks, zero for
    stateless levels.  ``None`` (every prefill/batch source) keeps the
    engine's state queries inert."""

    params: Sequence[int]
    macs: Sequence[int]
    weight_bytes: Sequence[int]
    cut_bytes: Sequence[int]
    time_s: Optional[Sequence[float]] = None
    weight_load_s: Optional[Sequence[float]] = None
    state_bytes: Optional[Sequence[int]] = None


def _analytic_depth_time(macs: int, weight_bytes: int,
                         spec: EdgeTPUSpec) -> float:
    """The analytic model's compute+weight-load time of one depth level."""
    return (macs / spec.macs_per_s
            + weight_bytes / (spec.weight_load_gbps * 1e9))


class CostSource:
    """Base class / protocol.  Subclasses override :meth:`materialize`;
    the per-depth point queries are derived from it."""

    name: str = "abstract"

    def materialize(self, graph: LayerGraph, spec: EdgeTPUSpec
                    ) -> DepthCosts:
        raise NotImplementedError

    def _cached_costs(self, graph: LayerGraph, spec) -> DepthCosts:
        """One-entry materialization memo (identity-keyed) so the per-depth
        point queries below are O(1) per call instead of re-running the
        O(depth) materialize per depth."""
        hit = getattr(self, "_dc_cache", None)
        if hit is not None and hit[0] is graph and hit[1] is spec:
            return hit[2]
        dc = self.materialize(graph, spec)
        self._dc_cache = (graph, spec, dc)
        return dc

    # -- per-depth point queries (protocol surface) --------------------------
    def layer_time_s(self, depth: int, graph: LayerGraph,
                     spec: EdgeTPUSpec) -> float:
        """Modeled/measured compute time of one depth level on the device
        ``spec`` describes (transfer terms excluded — those depend on the
        segment, not the layer)."""
        dc = self._cached_costs(graph, spec)
        if dc.time_s is not None:
            return dc.time_s[depth]
        return _analytic_depth_time(dc.macs[depth], dc.weight_bytes[depth],
                                    spec)

    def layer_params(self, depth: int, graph: LayerGraph) -> int:
        return graph.params_per_depth()[depth]

    def layer_weight_bytes(self, depth: int, graph: LayerGraph) -> int:
        return graph.bytes_per_depth()[depth]

    def activation_bytes(self, depth: int, graph: LayerGraph) -> int:
        """Host-transfer bytes crossing a cut placed after ``depth``."""
        return graph.out_bytes_per_depth()[depth]

    def describe(self) -> str:
        return self.name


class AnalyticCostSource(CostSource):
    """The closed-form model — wraps today's formulas exactly.

    ``materialize`` hands the engine the graph's own per-depth integer
    arrays (the very same cached list objects) and no measured times, so
    the engine's arithmetic — and therefore every plan — is bit-identical
    to the pre-CostSource code."""

    name = "analytic"

    def materialize(self, graph: LayerGraph, spec: EdgeTPUSpec
                    ) -> DepthCosts:
        return DepthCosts(
            params=graph.params_per_depth(),
            macs=graph.macs_per_depth(),
            weight_bytes=graph.bytes_per_depth(),
            cut_bytes=graph.out_bytes_per_depth(),
            time_s=None, weight_load_s=None)


class _TraceBackedSource(CostSource):
    """Shared machinery: per-depth measured/predicted times with analytic
    fallback for unprofiled depths + device scaling."""

    def __init__(self, trace: ProfileTrace,
                 reference_spec: Optional[EdgeTPUSpec] = None):
        self.trace = trace
        self.reference_spec = reference_spec or EdgeTPUSpec()

    def _predicted_time(self, depth: int) -> Optional[float]:
        """Time for a profiled depth on the reference device, or None when
        the trace does not cover it."""
        raise NotImplementedError

    def _scale_for(self, spec: EdgeTPUSpec) -> float:
        ref = self.reference_spec
        if spec.macs_per_s == ref.macs_per_s:
            return 1.0
        return ref.macs_per_s / spec.macs_per_s

    def materialize(self, graph: LayerGraph, spec: EdgeTPUSpec
                    ) -> DepthCosts:
        macs_pd = graph.macs_per_depth()
        bytes_pd = graph.bytes_per_depth()
        scale = self._scale_for(spec)
        wl_rate = spec.weight_load_gbps * 1e9
        times = []
        wloads = []
        for d in range(graph.depth):
            t = self._predicted_time(d)
            if t is None:            # unprofiled depth: analytic fallback
                t = _analytic_depth_time(macs_pd[d], bytes_pd[d], spec)
            elif scale != 1.0:
                t = t * scale
            # the weight-load fraction (non-amortizing under replication)
            # is the analytic fill-rate term, clamped to the measured
            # total — a replica cannot spend longer loading weights than
            # the whole level measured
            wloads.append(min(t, bytes_pd[d] / wl_rate))
            times.append(t)
        return DepthCosts(
            params=graph.params_per_depth(), macs=macs_pd,
            weight_bytes=bytes_pd, cut_bytes=graph.out_bytes_per_depth(),
            time_s=times, weight_load_s=wloads)


class TraceCostSource(_TraceBackedSource):
    """Plan from raw measured per-depth times (the paper's SEGM_PROF /
    SEGM_BALANCED profiling loop, with a persisted artifact standing in
    for the live device)."""

    name = "trace"

    def __init__(self, trace: ProfileTrace,
                 reference_spec: Optional[EdgeTPUSpec] = None):
        super().__init__(trace, reference_spec)
        self._times = trace.depth_time_map()

    def _predicted_time(self, depth: int) -> Optional[float]:
        return self._times.get(depth)

    def describe(self) -> str:
        return f"trace({self.trace.graph_name} @ {self.trace.device})"


class CalibratedCostSource(_TraceBackedSource):
    """The analytic model with coefficients least-squares-fit to a trace.

    Falls back to the *uncalibrated* analytic prediction when the trace is
    too small to fit (< 2 samples) and for unprofiled depths.  The fit is
    deterministic: the same trace always yields the same coefficients
    (and therefore the same plans)."""

    name = "calibrated"

    def __init__(self, trace: ProfileTrace,
                 reference_spec: Optional[EdgeTPUSpec] = None):
        super().__init__(trace, reference_spec)
        from .calibrate import cliff_bytes_per_depth
        ref = self.reference_spec
        capacity = ref.onchip_bytes - ref.fixed_reserve
        try:
            self.fit: Optional[CalibrationFit] = fit_trace(
                trace, capacity_bytes=capacity)
        except ValueError:
            self.fit = None
        self._sample_by_depth = {s.depth: s for s in trace.samples}
        # the cliff regressor, positioned exactly as fit_trace saw it —
        # prediction must apply every coefficient the fit solved for
        ordered = sorted(trace.samples, key=lambda s: s.depth)
        cliffs = cliff_bytes_per_depth(
            tuple(s.weight_bytes for s in ordered), capacity)
        self._cliff_by_depth = {s.depth: c
                                for s, c in zip(ordered, cliffs)}

    def _predicted_time(self, depth: int) -> Optional[float]:
        if self.fit is None:
            return None
        s = self._sample_by_depth.get(depth)
        if s is None:
            return None
        return self.fit.predict(s.macs, s.weight_bytes, s.act_bytes,
                                cliff_bytes=self._cliff_by_depth[depth],
                                low_intensity_macs=s.low_intensity_macs)

    def coefficients(self) -> Dict:
        return {} if self.fit is None else self.fit.to_dict()

    def describe(self) -> str:
        tag = "unfit" if self.fit is None else (
            f"mac_s={self.fit.mac_s:.3e}, "
            f"load={self.fit.load_s_per_byte:.3e} s/B, "
            f"fix={self.fit.fixed_s:.3e} s")
        return f"calibrated({self.trace.graph_name}: {tag})"


# ---------------------------------------------------------------------------
# spec-string resolution
# ---------------------------------------------------------------------------
COST_SOURCE_KINDS = ("analytic", "trace", "calibrated")


def parse_cost_source(ref: str) -> Tuple[str, Optional[str]]:
    """``"analytic"`` / ``"trace:<path>"`` / ``"calibrated:<path>"`` ->
    (kind, path).  Raises ValueError on malformed refs (shared by
    DeploymentSpec validation, so bad specs fail at construction)."""
    kind, _, path = ref.partition(":")
    if kind == "analytic":
        if path:
            raise ValueError(f"'analytic' cost source takes no argument, "
                             f"got {ref!r}")
        return kind, None
    if kind in ("trace", "calibrated"):
        if not path:
            raise ValueError(f"cost source {ref!r} needs a trace path: "
                             f"'{kind}:<path>'")
        return kind, path
    raise ValueError(f"unknown cost source {ref!r}; expected 'analytic', "
                     f"'trace:<path>' or 'calibrated:<path>'")


def resolve_cost_source(ref: str,
                        reference_spec: Optional[EdgeTPUSpec] = None
                        ) -> CostSource:
    """Turn a ``DeploymentSpec.cost_source`` string into a live source
    (loading the trace artifact for the trace-backed kinds)."""
    kind, path = parse_cost_source(ref)
    if kind == "analytic":
        return AnalyticCostSource()
    trace = ProfileTrace.load(path)
    cls = TraceCostSource if kind == "trace" else CalibratedCostSource
    return cls(trace, reference_spec=reference_spec)
