"""Reduce a ``torch.profiler`` trace of a run's traced batches to what the
per-layer metrics read.

The union of device intervals is ``launch/profile_serve.py``'s
``_union_us``, copied.  A kernel counts as launched under an operator when
the operator, or one it ran inside, made the launch (the profiler ties a
kernel to the innermost operator that launched it).
"""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from torch.autograd import DeviceType

def union_us(spans: Iterable[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def _merged(spans: Iterable[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


class Trace:
    """The device and host events of one profiled stretch of ``wall_s``
    seconds on ``devices`` (card indices)."""

    def __init__(self, prof, wall_s: float, devices: Sequence[int]):
        self.wall_s = wall_s
        self.devices = list(devices)
        events = prof.events()
        self.device_events = [
            (e.device_index, e.time_range.start, e.time_range.end, e.name)
            for e in events if e.device_type == DeviceType.CUDA]
        self.cpu = [e for e in events if e.device_type == DeviceType.CPU]

    # -- the device ---------------------------------------------------------
    def busy_s(self, device: int) -> float:
        return union_us((lo, hi) for d, lo, hi, _ in self.device_events
                        if d == device) / 1e6

    def mean_busy_s(self) -> float:
        return sum(self.busy_s(d) for d in self.devices) / len(self.devices)

    def kernel_s(self, key: str) -> Tuple[float, int]:
        """(seconds, count) of the device events whose name holds
        ``key``."""
        spans = [hi - lo for _, lo, hi, n in self.device_events if key in n]
        return sum(spans) / 1e6, len(spans)

    def total_kernel_s(self) -> float:
        return sum(hi - lo for _, lo, hi, _ in self.device_events) / 1e6

    # -- kernels by the operator that launched them ---------------------------
    def kernel_s_under(self, op_names: Sequence[str]) -> float:
        """Seconds of the kernels launched inside an operator named one of
        ``op_names``."""
        names = set(op_names)
        total = 0.0
        for e in self.cpu:
            if not e.kernels:
                continue
            p = e
            while p is not None and p.name not in names:
                p = p.cpu_parent
            if p is not None:
                total += sum(k.duration for k in e.kernels)
        return total / 1e6

    # -- the breakdown ------------------------------------------------------
    def top_ops(self, n: int = 10) -> List[List]:
        """The device operations that took most time, summed over the
        devices: [[name, seconds], ...]."""
        by: Dict[str, float] = {}
        for _, lo, hi, name in self.device_events:
            by[name] = by.get(name, 0.0) + (hi - lo) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def _host_at(self, t: float, starts: List[float], spans) -> str:
        """The innermost host event running at ``t`` (µs)."""
        best: Optional[Tuple[float, str]] = None
        i = bisect.bisect_right(starts, t)
        for lo, hi, name in spans[max(0, i - 4000):i]:
            if lo <= t < hi and (best is None or hi - lo < best[0]):
                best = (hi - lo, name)
        return best[1] if best else "python (no operator)"

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The device's idle gaps, longest first, by what the host was
        doing when each began, summed by that name over the devices:
        [[name, seconds], ...] of the longest ``4 n`` gaps."""
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in self.cpu)
        starts = [s[0] for s in spans]
        gaps = []
        for d in self.devices:
            merged = _merged((lo, hi) for dd, lo, hi, _ in self.device_events
                             if dd == d)
            gaps += [(b[0] - a[1], a[1]) for a, b in zip(merged, merged[1:])]
        by: Dict[str, float] = {}
        for dt, at in sorted(gaps, reverse=True)[:4 * n]:
            name = self._host_at(at, starts, spans)
            by[name] = by.get(name, 0.0) + dt / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]
