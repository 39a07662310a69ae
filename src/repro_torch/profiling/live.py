"""LiveTraceBuilder: fold serving telemetry into a rolling ProfileTrace.

The profile -> calibrate -> plan workflow is offline and file-based
(``trace:<path>``): a :mod:`repro_torch.profiling.profiler` run on an idle device
produces the artifact the planner consumes.  A *serving* pipeline measures
the same quantity for free — the executor's monotonic busy/items counters
give an observed per-item time for every stage of the live plan — but at
stage granularity, not the per-depth granularity the cost sources need.

This module closes that gap.  A :class:`LiveTraceBuilder` precomputes the
graph's static per-depth costs (MACs, weight bytes, activation bytes,
low-intensity MACs — exactly the columns the offline profiler records)
and, on every telemetry window, **apportions** each stage's observed
per-item time across the depth levels the stage spans, proportionally to
the analytic model's per-depth time share.  The analytic model's *shape*
within a stage is the best available prior (relative layer weights); its
*scale* is exactly what the observation corrects.  Per-depth estimates are
EWMA-smoothed across windows, and :meth:`trace` emits a standard
:class:`~repro_torch.profiling.trace.ProfileTrace` over the covered depths —
partial coverage is legal, unprofiled depths fall back to analytic, and
:meth:`cost_source` wraps the current trace in a
:class:`~repro_torch.profiling.sources.CalibratedCostSource` (structural
extrapolation to depths no live stage has visited yet) ready to hand to
``plan(..., cost_source=...)``.

This is the telemetry half of the self-healing loop
(:mod:`repro_torch.runtime.selfheal`): observe -> refit -> replan -> canary.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..core.edge_tpu_model import EdgeTPUSpec
from ..core.graph import LayerGraph
from .sources import (CalibratedCostSource, CostSource, TraceCostSource,
                      _analytic_depth_time)
from .trace import DepthSample, ProfileTrace

# same roofline knee the offline profiler uses (profiler.py): layers with
# fewer MACs per produced activation byte than this are memory-bound
LOW_INTENSITY_MACS_PER_BYTE = 32.0


class LiveTraceBuilder:
    """Accumulate observed per-stage times into per-depth estimates.

    ``alpha`` is the EWMA smoothing factor per depth (the first
    observation seats the estimate directly, so a cold builder converges
    in one window).  ``observe`` is cheap — O(depth) per window — and
    thread-compatible with the self-healing controller's single-writer
    discipline (one controller thread calls it; ``trace()`` copies).
    """

    def __init__(self, graph: LayerGraph,
                 reference_spec: Optional[EdgeTPUSpec] = None,
                 alpha: float = 0.25, device: str = "live"):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.graph = graph
        self.reference_spec = reference_spec or EdgeTPUSpec()
        self.alpha = alpha
        self.device = device
        # static per-depth cost columns, exactly as the offline profiler
        # records them (profiler.profile_model)
        levels = graph.levels()
        self._layers = [tuple(lvl) for lvl in levels]
        self._params = list(graph.params_per_depth())
        self._macs = list(graph.macs_per_depth())
        self._weight_bytes = list(graph.bytes_per_depth())
        self._act_bytes = [sum(graph.nodes[n].out_bytes for n in lvl)
                           for lvl in levels]
        self._low_macs = [sum(graph.nodes[n].macs for n in lvl
                              if graph.nodes[n].macs
                              <= LOW_INTENSITY_MACS_PER_BYTE
                              * max(1, graph.nodes[n].out_bytes))
                          for lvl in levels]
        # analytic per-depth time: the apportioning prior (shape within a
        # stage); scale comes from the observation
        self._prior = [_analytic_depth_time(self._macs[d],
                                            self._weight_bytes[d],
                                            self.reference_spec)
                       for d in range(graph.depth)]
        self._est: Dict[int, float] = {}    # depth -> EWMA'd time_s
        self.windows = 0                    # observe() calls that landed

    # -- ingestion -----------------------------------------------------------
    def observe(self, stage_ranges: Sequence[Tuple[int, int]],
                stage_time_per_item_s: Sequence[float],
                stage_items: Optional[Sequence[int]] = None) -> int:
        """Fold one telemetry window in.  ``stage_ranges`` are the live
        plan's inclusive ``(lo, hi)`` depth ranges;
        ``stage_time_per_item_s`` the window's observed per-item stage
        times (``snapshot()['stage_time_per_req_s']``).  Stages with no
        signal (0.0 per-item time, or 0 items when ``stage_items`` is
        given) are skipped — an empty window teaches nothing.  Returns the
        number of depth levels updated."""
        assert len(stage_ranges) == len(stage_time_per_item_s)
        updated = 0
        for i, ((lo, hi), t_item) in enumerate(
                zip(stage_ranges, stage_time_per_item_s)):
            if t_item <= 0.0:
                continue
            if stage_items is not None and stage_items[i] <= 0:
                continue
            prior = [max(self._prior[d], 1e-12)
                     for d in range(lo, hi + 1)]
            total = sum(prior)
            for d, p in zip(range(lo, hi + 1), prior):
                obs = t_item * (p / total)
                old = self._est.get(d)
                self._est[d] = (obs if old is None
                                else self.alpha * obs
                                + (1 - self.alpha) * old)
                updated += 1
        if updated:
            self.windows += 1
        return updated

    # -- queries -------------------------------------------------------------
    def coverage(self) -> float:
        """Fraction of the graph's depth levels with a live estimate."""
        return len(self._est) / max(1, self.graph.depth)

    def depth_time(self, depth: int) -> Optional[float]:
        return self._est.get(depth)

    def trace(self) -> ProfileTrace:
        """The current estimates as a standard (partial) ProfileTrace —
        consumable by every trace-backed cost source, saveable for
        offline audit."""
        samples = tuple(
            DepthSample(depth=d, time_s=self._est[d],
                        layers=self._layers[d],
                        params=self._params[d], macs=self._macs[d],
                        weight_bytes=self._weight_bytes[d],
                        act_bytes=self._act_bytes[d],
                        low_intensity_macs=self._low_macs[d])
            for d in sorted(self._est))
        return ProfileTrace(graph_name=self.graph.name, samples=samples,
                            device=self.device, repeats=self.windows)

    def cost_source(self, kind: str = "calibrated") -> CostSource:
        """The current trace wrapped as a planner-ready cost source.
        ``calibrated`` (default) refits the analytic coefficients — it
        extrapolates structurally to depths no live stage has covered;
        ``trace`` prices covered depths raw with analytic fallback."""
        tr = self.trace()
        if kind == "calibrated":
            return CalibratedCostSource(
                tr, reference_spec=self.reference_spec)
        if kind == "trace":
            return TraceCostSource(tr, reference_spec=self.reference_spec)
        raise ValueError(f"unknown live cost-source kind {kind!r}")
