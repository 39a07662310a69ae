"""Least-squares calibration of the analytic cost model against a trace.

The analytic Edge TPU model predicts a depth level's compute time as a
linear form in the level's static costs::

    t(d) = macs(d) * c_mac + low_intensity_macs(d) * c_low
           + weight_bytes(d) * c_load + act_bytes(d) * c_act
           + cliff_bytes(d) * c_cliff + c_fix

* ``c_mac`` — seconds per MAC (the inverse sustained MAC rate);
* ``c_low`` — *extra* seconds per MAC in layers below the roofline knee
  (depthwise convs, pooling: few MACs per activation byte, executed at a
  far lower rate — a single MAC rate is exactly what Seshadri et al.
  show mispredicting on the Edge TPU, and XLA-CPU behaves the same way);
* ``c_load`` — seconds per weight byte (systolic-array fill / streaming);
* ``c_act`` — seconds per activation byte produced (memory traffic of
  the layer's output);
* ``c_cliff`` — *extra* seconds per weight byte past the on-chip-memory
  cliff (Seshadri et al., PAPERS.md: layer times jump by large factors
  once cumulative weights exceed on-chip capacity and spill to host —
  ``cliff_bytes(d)`` is the portion of depth ``d``'s weights beyond that
  capacity under the whole-model greedy placement);
* ``c_fix`` — fixed per-level dispatch overhead.

:func:`fit_trace` solves for the coefficients by least squares over the
trace's samples, with negative coefficients clamped to zero and the system
re-solved without them (physical rates cannot be negative; the iteration
is deterministic, so the same trace always yields the same fit — asserted
in tests/test_profiling.py).  The rows are weighted by ``1 / time`` so the
solver minimizes *relative* residuals: per-layer times span orders of
magnitude within one model, and an unweighted fit buys accuracy on the
few big layers by over-predicting the many small ones — exactly the
mean-relative-stage-error metric the calibration exists to reduce.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

MIB = 1024 * 1024


@dataclasses.dataclass(frozen=True)
class CalibrationFit:
    """Fitted per-device coefficients of the analytic time model."""

    mac_s: float            # seconds per MAC (compute-bound regime)
    low_mac_s: float        # EXTRA seconds per MAC below the roofline
                            # knee (depthwise/pooling: memory-bound)
    load_s_per_byte: float  # seconds per on-chip weight byte
    act_s_per_byte: float   # seconds per activation byte produced
    cliff_s_per_byte: float  # extra seconds per byte past the memory cliff
    fixed_s: float          # per-depth-level fixed overhead
    n_samples: int
    residual_rms_s: float

    @property
    def macs_per_s(self) -> float:
        return 1.0 / self.mac_s if self.mac_s > 0 else float("inf")

    @property
    def weight_load_gbps(self) -> float:
        return (1.0 / (self.load_s_per_byte * 1e9)
                if self.load_s_per_byte > 0 else float("inf"))

    def predict(self, macs: int, weight_bytes: int, act_bytes: int = 0,
                cliff_bytes: int = 0, low_intensity_macs: int = 0) -> float:
        return (macs * self.mac_s
                + low_intensity_macs * self.low_mac_s
                + weight_bytes * self.load_s_per_byte
                + act_bytes * self.act_s_per_byte
                + cliff_bytes * self.cliff_s_per_byte + self.fixed_s)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def cliff_bytes_per_depth(weight_bytes: Tuple[int, ...],
                          capacity_bytes: int) -> Tuple[int, ...]:
    """Portion of each depth's weight bytes past ``capacity_bytes`` when
    depths are placed greedily in order (the on-chip-memory cliff of the
    whole-model placement).

    Caveat: callers pass the weights of the depths they *have* — for a
    partial trace the accumulation skips the unprofiled depths' weights,
    placing the cliff later than the full model would.  Full-coverage
    traces (what the profiler captures) are exact."""
    out = []
    cum = 0
    for b in weight_bytes:
        below = max(0, min(b, capacity_bytes - cum))
        out.append(b - below)
        cum += b
    return tuple(out)


def fit_trace(trace, capacity_bytes: Optional[int] = None
              ) -> CalibrationFit:
    """Fit the four coefficients to a :class:`ProfileTrace`.

    ``capacity_bytes`` is the on-chip weight capacity used to locate the
    cliff (default: the reference Edge TPU's 8 MiB minus the fixed
    reserve).  Raises ValueError on traces with fewer than 2 samples —
    a single point cannot constrain a rate.
    """
    samples = sorted(trace.samples, key=lambda s: s.depth)
    if len(samples) < 2:
        raise ValueError(f"calibration needs >= 2 trace samples, "
                         f"got {len(samples)}")
    if capacity_bytes is None:
        capacity_bytes = 8 * MIB - int(0.1 * MIB)
    bytes_pd = tuple(s.weight_bytes for s in samples)
    cliff = cliff_bytes_per_depth(bytes_pd, capacity_bytes)
    X = np.array([[s.macs, s.low_intensity_macs, s.weight_bytes,
                   s.act_bytes, c, 1.0]
                  for s, c in zip(samples, cliff)], dtype=np.float64)
    y = np.array([s.time_s for s in samples], dtype=np.float64)
    # relative-error weighting: scale each row by 1/time so small levels
    # count as much as big ones (guarded against zero-time samples)
    w = 1.0 / np.maximum(y, 1e-12)
    Xw = X * w[:, None]
    yw = y * w

    # non-negative least squares via deterministic clamp-and-refit: solve,
    # drop the most-negative column, repeat (at most 4 rounds)
    active = list(range(X.shape[1]))
    coef = np.zeros(X.shape[1])
    while active:
        sol, *_ = np.linalg.lstsq(Xw[:, active], yw, rcond=None)
        neg = [(v, c) for v, c in zip(sol, active) if v < 0.0]
        if not neg:
            coef[:] = 0.0
            for v, c in zip(sol, active):
                coef[c] = v
            break
        worst = min(neg)[1]           # most negative coefficient
        active.remove(worst)
    resid = y - X @ coef
    rms = float(np.sqrt(np.mean(resid * resid)))
    return CalibrationFit(
        mac_s=float(coef[0]), low_mac_s=float(coef[1]),
        load_s_per_byte=float(coef[2]), act_s_per_byte=float(coef[3]),
        cliff_s_per_byte=float(coef[4]), fixed_s=float(coef[5]),
        n_samples=len(samples), residual_rms_s=rms)
