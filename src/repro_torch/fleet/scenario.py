"""Synthetic multi-tenant traffic generator, run by ``launch/serve.py
--fleet``.

A :class:`FleetScenario` turns a :class:`~repro_torch.fleet.spec.FleetSpec`
into something that actually serves: sleep-based stage functions whose
per-depth service times are a *static synthetic truth* (each member's
whole-model time is pinned by ``service_sum_s``, distributed across
depths by the analytic MAC + weight-byte shape), so every latency the
run observes is a property of the committed plans and the traffic — not
of host noise.  Every request's completion is tapped (via the router's
race-free ``on_done`` hook) in merge-exit order, giving the 0-lost /
0-misordered audit across every autoscaler hot-swap: the executor's
merge restores stream order after replicated stages, so per member the
successful completions must come back in submission order exactly.

Traffic is window-driven: a :class:`TrafficPhase` says how many
requests each member submits per window; phase boundaries are the
mid-run shifts the autoscaler must chase.  :meth:`FleetScenario.drive`
runs phases against a live :class:`~repro_torch.fleet.deploy.Fleet`, ticking
its autoscaler once per window, and folds everything into per-member
metrics with an SLO-attainment summary (fraction of submitted requests
completed within the member's p95 target — a shed, late, or lost
request counts against attainment, so surviving-request percentiles
cannot flatter an overloaded member).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

from ..api.spec import resolve_model_graph
from ..core.graph import LayerGraph
from .deploy import Fleet, deploy_fleet
from .spec import FleetSpec

# synthetic device constants (same flavor as the self-healing bench):
# dense MACs + weight-byte streaming set the per-depth shape
_MAC_RATE = 4.0e12
_WEIGHT_RATE = 30e9


def true_depth_times(g: LayerGraph, service_sum_s: float) -> List[float]:
    """Per-depth service times whose sum is exactly ``service_sum_s``,
    shaped by the analytic MAC + weight-load profile."""
    macs = g.macs_per_depth()
    wb = g.bytes_per_depth()
    raw = [m / _MAC_RATE + b / _WEIGHT_RATE for m, b in zip(macs, wb)]
    total = sum(raw)
    if total <= 0:
        raw = [1.0] * g.depth
        total = float(g.depth)
    return [t * service_sum_s / total for t in raw]


@dataclasses.dataclass(frozen=True)
class TrafficPhase:
    """``windows`` windows of ``rates[member]`` requests per window."""

    windows: int
    rates: Dict[str, int]


class FleetScenario:
    """One runnable multi-tenant serving scenario.

    ``service_sum_s`` maps member name -> that model's whole-model true
    service time (the sleep budget one request costs end to end on one
    device).  Build the runtime with :meth:`deploy` (or hand
    :meth:`builders` / :attr:`graphs` to ``deploy_fleet`` yourself),
    then :meth:`drive` phases through it.
    """

    def __init__(self, spec: FleetSpec,
                 service_sum_s: Dict[str, float]):
        missing = [n for n in spec.member_names if n not in service_sum_s]
        if missing:
            raise ValueError(f"service_sum_s missing members: {missing}")
        self.spec = spec
        self.graphs: Dict[str, LayerGraph] = {
            m.name: resolve_model_graph(m.spec.model)
            for m in spec.members}
        self.true_s: Dict[str, List[float]] = {
            n: true_depth_times(self.graphs[n], service_sum_s[n])
            for n in spec.member_names}
        self._tap_lock = threading.Lock()
        self.exit_order: Dict[str, List[int]] = {
            n: [] for n in spec.member_names}
        self._next_id: Dict[str, int] = {n: 0 for n in spec.member_names}
        self.lost: Dict[str, int] = {n: 0 for n in spec.member_names}

    # -- stage functions -----------------------------------------------------
    def builder_for(self, name: str):
        """Stage-fn builder for one member: each stage sleeps its depth
        range's true time.  (Exit order is tapped at request completion,
        not inside a stage fn — replicated-stage workers run concurrently
        and only the executor's merge restores stream order.)"""
        true_s = self.true_s[name]

        def builder(pl):
            fns = []
            for (lo, hi) in pl.stage_depth_ranges:
                dt = sum(true_s[d] for d in range(lo, hi + 1))

                def fn(x, dt=dt):
                    time.sleep(dt)
                    return x
                fns.append(fn)
            return fns
        return builder

    def builders(self) -> Dict[str, Any]:
        return {n: self.builder_for(n) for n in self.spec.member_names}

    def deploy(self, **kwargs) -> Fleet:
        """``deploy_fleet`` with this scenario's graphs and builders."""
        return deploy_fleet(self.spec, graphs=self.graphs,
                            stage_fn_builders=self.builders(), **kwargs)

    def _tap(self, name: str):
        """Completion tap: successful exits append in merge-exit order
        (errored requests never crossed the pipeline tail)."""
        order = self.exit_order[name]

        def on_done(req):
            if req.error is None:
                with self._tap_lock:
                    order.append(int(req.result))
        return on_done

    # -- traffic -------------------------------------------------------------
    def drive(self, fleet: Fleet, phases: List[TrafficPhase], *,
              tick_autoscaler: bool = True,
              wait_timeout_s: float = 60.0) -> Dict[str, Any]:
        """Run the phases: each window submits every member's quota
        through the fleet front door, waits for the window to resolve,
        then ticks the autoscaler once (when present and enabled).
        Returns per-member metrics; cumulative across calls on the same
        scenario (ids keep counting, exit order keeps appending)."""
        metrics = {n: {"submitted": 0, "completed": 0, "failed": 0,
                       "shed": 0, "deadline_exceeded": 0,
                       "within_slo": 0, "latencies_s": []}
                   for n in self.spec.member_names}
        for phase in phases:
            unknown = set(phase.rates) - set(self.spec.member_names)
            if unknown:
                raise ValueError(f"phase rates name non-members: "
                                 f"{sorted(unknown)}")
            for _ in range(phase.windows):
                window = []
                for name, rate in phase.rates.items():
                    for _ in range(rate):
                        rid = self._next_id[name]
                        self._next_id[name] += 1
                        window.append(
                            (name, fleet.submit(name, rid,
                                                on_done=self._tap(name))))
                for name, req in window:
                    m = metrics[name]
                    m["submitted"] += 1
                    if not req.event.wait(wait_timeout_s):
                        self.lost[name] += 1
                        continue
                    if req.error is None:
                        lat = req.t_done - req.t_submit
                        m["completed"] += 1
                        m["latencies_s"].append(lat)
                        slo = self.spec.member(name).spec.slo_p95_ms
                        if slo is None or lat <= slo / 1e3:
                            m["within_slo"] += 1
                    else:
                        m["failed"] += 1
                        kind = type(req.error).__name__
                        if kind == "Overloaded":
                            m["shed"] += 1
                        elif kind == "DeadlineExceeded":
                            m["deadline_exceeded"] += 1
                if (tick_autoscaler and fleet.autoscaler is not None):
                    fleet.autoscaler.tick()
        return metrics

    # -- audit / summary -----------------------------------------------------
    def misordered(self, name: str) -> int:
        order = self.exit_order[name]
        return sum(1 for a, b in zip(order, order[1:]) if b < a)

    def audit(self) -> Dict[str, Any]:
        """Zero-loss / zero-misorder accounting per member.  ``exited``
        counts successful merge-exit completions (shed / expired
        requests resolve with an error and never cross the pipeline
        tail); the invariant checked here is *no hang and no reorder*
        across every hot-swap — the drain contract."""
        return {n: {"submitted": self._next_id[n],
                    "exited": len(self.exit_order[n]),
                    "lost": self.lost[n],
                    "misordered": self.misordered(n)}
                for n in self.spec.member_names}

    def attainment(self, metrics: Dict[str, Any]) -> Dict[str, float]:
        """Per-member SLO attainment in [0, 1]: the fraction of
        submitted requests that completed within the p95 target
        (completed at all, for members without one)."""
        out = {}
        for name, m in metrics.items():
            if m["submitted"] == 0:
                out[name] = 1.0
                continue
            out[name] = m["within_slo"] / m["submitted"]
        return out

    @staticmethod
    def worst(attainment: Dict[str, float]) -> float:
        return min(attainment.values())


def summarize_member(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Fold one member's metrics into a JSON-friendly record."""
    from ..serving.server import latency_percentiles
    lat = latency_percentiles(metrics["latencies_s"])
    return {
        "submitted": metrics["submitted"],
        "completed": metrics["completed"],
        "failed": metrics["failed"],
        "shed": metrics["shed"],
        "deadline_exceeded": metrics["deadline_exceeded"],
        "within_slo": metrics["within_slo"],
        "p50_ms": round(lat["p50_s"] * 1e3, 3),
        "p95_ms": round(lat["p95_s"] * 1e3, 3),
        "p99_ms": round(lat["p99_s"] * 1e3, 3),
    }
