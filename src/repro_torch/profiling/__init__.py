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
  per-device coefficients against a trace.

``trace.py``, ``calibrate.py`` and ``sources.py`` are copies of the
reference's jax-free modules.  The online variant (``live.py``'s
``LiveTraceBuilder``, the feedback half of the self-healing loop) is not
ported yet.
"""
from .calibrate import CalibrationFit, cliff_bytes_per_depth, fit_trace
from .profiler import profile_model, trimmed_mean
from .sources import (AnalyticCostSource, CalibratedCostSource, CostSource,
                      DepthCosts, TraceCostSource, parse_cost_source,
                      resolve_cost_source)
from .trace import TRACE_FORMAT, DepthSample, ProfileTrace


def __getattr__(name):
    if name == "LiveTraceBuilder":
        raise NotImplementedError(
            "LiveTraceBuilder: the live trace source (profiling/live.py, "
            "the feedback half of the self-healing loop) is not ported to "
            "repro_torch yet; it is the self-healing slice")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ProfileTrace", "DepthSample", "TRACE_FORMAT",
    "profile_model", "trimmed_mean",
    "CostSource", "DepthCosts", "AnalyticCostSource", "TraceCostSource",
    "CalibratedCostSource", "parse_cost_source", "resolve_cost_source",
    "CalibrationFit", "fit_trace", "cliff_bytes_per_depth",
]
