"""Profiling, trace, and calibration: the pluggable cost layer.

Ported from ``repro/profiling``.  The paper's segmentation is
profile-based — measured per-layer times on the real device drive the
balanced cuts.  This package provides that loop on the card:

* :func:`profile_model` — run a ``GraphModel`` depth-by-depth under
  ``time.perf_counter`` with the card synchronized (warmup / repeats /
  trimmed mean) and capture a versioned, JSON-persisted
  :class:`ProfileTrace` (the reference's ``repro.profile_trace/v1``);
* :class:`CostSource` and its three implementations
  (:class:`AnalyticCostSource`, :class:`TraceCostSource`,
  :class:`CalibratedCostSource`) — the seam the
  :class:`~repro_torch.core.cost_engine.SegmentCostEngine` prices segments
  through, selected per-deployment via ``DeploymentSpec.cost_source``
  (``"analytic"`` / ``"trace:<path>"`` / ``"calibrated:<path>"``);
* :func:`fit_trace` — least-squares calibration of the analytic model's
  per-device coefficients against a trace;
* :class:`LiveTraceBuilder` — the online variant: fold serving telemetry
  (observed per-stage per-item times) into a rolling partial trace and a
  continuously-refit calibrated source, the feedback half of the
  self-healing loop (:mod:`repro_torch.runtime.selfheal`);
* :func:`spans.span` — the program's one way to open a named range in
  the profiler's CPU trace (one flag check with no profiler running).

``trace.py``, ``calibrate.py``, ``sources.py`` and ``live.py`` are copies
of the reference's jax-free modules.
"""
from .calibrate import CalibrationFit, cliff_bytes_per_depth, fit_trace
from .live import LiveTraceBuilder
from .profiler import profile_model, trimmed_mean
from .sources import (AnalyticCostSource, CalibratedCostSource, CostSource,
                      DepthCosts, TraceCostSource, parse_cost_source,
                      resolve_cost_source)
from .trace import TRACE_FORMAT, DepthSample, ProfileTrace

__all__ = [
    "ProfileTrace", "DepthSample", "TRACE_FORMAT",
    "profile_model", "trimmed_mean",
    "CostSource", "DepthCosts", "AnalyticCostSource", "TraceCostSource",
    "CalibratedCostSource", "parse_cost_source", "resolve_cost_source",
    "CalibrationFit", "fit_trace", "cliff_bytes_per_depth",
    "LiveTraceBuilder",
]
