"""PlanReport: what a plan will do, before anything runs.

Every plan the front door produces carries one — modeled stage times
(raw and replication-amortized), the pacing bottleneck, params/time
imbalance, per-stage device memory (on-device bytes, host spill,
capacity), and *which cost source priced it*.  When the plan came from a
trace-backed source the report also records the measured per-stage
compute times and the modeled-vs-trace stage-time error — the number the
calibration loop (EXPERIMENTS.md §Profiling & calibration) watches.  It
is the decision record a deployment pipeline logs next to the plan it
shipped, and it is JSON-round-trippable like the spec.

Degenerate plans yield *neutral* records instead of raising: a 1-stage
plan reports zero imbalance, an empty plan reports all-zero fields
(regression-tested in tests/test_deploy_api.py).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

from ..core.edge_tpu_model import EdgeTPUModel, EdgeTPUSpec
from ..core.graph import LayerGraph
from ..core.placement import PlacementPlan

REPORT_FORMAT = "repro.plan_report/v1"


@dataclasses.dataclass(frozen=True)
class PlanReport:
    """Modeled properties of one :class:`PlacementPlan`."""

    graph_name: str
    strategy: str
    n_stages: int
    n_devices: int
    # time (seconds; 0.0 where the plan carries no modeled time)
    stage_times_s: Tuple[float, ...] = ()
    effective_stage_times_s: Tuple[float, ...] = ()
    max_stage_time_s: float = 0.0
    bottleneck_stage: int = -1          # -1: no timed stages
    imbalance_time_pct: float = 0.0     # (max - min) / max over pacing times
    # size
    stage_params: Tuple[int, ...] = ()
    imbalance_params: int = 0           # paper Table 5's Δs
    # memory (bytes; empty when no graph was available to price against)
    stage_device_bytes: Tuple[int, ...] = ()
    stage_host_bytes: Tuple[int, ...] = ()
    stage_capacity_bytes: Tuple[int, ...] = ()
    spill_bytes: int = 0                # total host overflow across stages
    # placement
    devices: Tuple[str, ...] = ()
    replicas: Tuple[int, ...] = ()
    # provenance: which cost source priced the plan, and how the modeled
    # stage times compare against the trace when one is available
    cost_source: str = "analytic"
    trace_stage_times_s: Tuple[float, ...] = ()
    stage_time_error_pct: float = -1.0    # -1: no trace to compare against
    # decode operating point (workload="decode" plans only; see
    # repro.decode.placement.decode_info)
    decode_tokens_per_s: float = 0.0
    decode_concurrency: int = 0           # 0: not a decode plan
    decode_max_context: int = 0
    stage_kv_bytes: Tuple[int, ...] = ()
    stage_kv_cap_bytes: Tuple[int, ...] = ()
    kv_headroom_pct: float = -1.0         # min over stages; -1: no KV view

    @property
    def spills(self) -> bool:
        return self.spill_bytes > 0

    @property
    def has_trace(self) -> bool:
        return self.stage_time_error_pct >= 0.0

    @property
    def is_decode(self) -> bool:
        return self.decode_concurrency > 0

    @classmethod
    def from_plan(cls, plan: PlacementPlan,
                  graph: Optional[LayerGraph] = None,
                  base_spec: Optional[EdgeTPUSpec] = None,
                  base_model: Optional[EdgeTPUModel] = None,
                  cost_source: str = "analytic",
                  trace=None, decode: Optional[Dict] = None) -> "PlanReport":
        """Price a plan.  ``base_model`` (preferred — the device model the
        planner itself priced with, so the report cannot contradict the
        plan) or ``graph`` [+ ``base_spec``] enables the per-stage memory
        columns; without either the report still carries the time/size
        view the plan itself knows.  ``trace`` (a
        :class:`~repro.profiling.trace.ProfileTrace` covering the plan's
        depths) enables the measured-stage-time column and the
        modeled-vs-trace error.  ``decode`` (the plan's ``decode_info``
        dict, from the decode_placement strategy) fills the decode
        operating-point columns."""
        stages = plan.stages
        times = tuple(0.0 if s.time_s is None else s.time_s for s in stages)
        eff = tuple(0.0 if t is None else t
                    for t in plan.effective_stage_times_s)
        timed = [(i, t) for i, t in enumerate(eff) if t > 0.0]
        if timed:
            bottleneck, max_t = max(timed, key=lambda it: it[1])
            min_t = min(t for _, t in timed)
            imb_pct = ((max_t - min_t) / max_t * 100.0
                       if len(timed) > 1 and max_t > 0 else 0.0)
        else:
            bottleneck, max_t, imb_pct = -1, 0.0, 0.0
        params = tuple(s.params for s in stages)
        imb_params = (max(params) - min(params)) if len(params) > 1 else 0

        dev_bytes: Tuple[int, ...] = ()
        host_bytes: Tuple[int, ...] = ()
        cap_bytes: Tuple[int, ...] = ()
        if base_model is None and graph is not None:
            base_model = EdgeTPUModel(graph, base_spec)
        if base_model is not None and stages:
            dev_list, host_list, cap_list = [], [], []
            for st in stages:
                spec = st.device.specialize(base_model.spec)
                eng = (base_model.engine if spec is base_model.spec
                       else base_model.engine.with_spec(spec))
                d, h = eng.segment_split(st.depth_lo, st.depth_hi)
                dev_list.append(d)
                host_list.append(h)
                cap_list.append(spec.onchip_bytes)
            dev_bytes = tuple(dev_list)
            host_bytes = tuple(host_list)
            cap_bytes = tuple(cap_list)

        trace_times: Tuple[float, ...] = ()
        err_pct = -1.0
        if trace is not None and stages:
            measured = trace.stage_times([(s.depth_lo, s.depth_hi)
                                          for s in stages])
            if measured is not None:
                trace_times = tuple(measured)
                rel = [abs(m - t) / t
                       for m, t in zip(times, trace_times) if t > 0.0]
                err_pct = (sum(rel) / len(rel) * 100.0) if rel else -1.0

        return cls(
            graph_name=plan.graph_name, strategy=plan.strategy,
            n_stages=plan.n_stages, n_devices=plan.n_devices,
            stage_times_s=times, effective_stage_times_s=eff,
            max_stage_time_s=max_t, bottleneck_stage=bottleneck,
            imbalance_time_pct=imb_pct,
            stage_params=params, imbalance_params=imb_params,
            stage_device_bytes=dev_bytes, stage_host_bytes=host_bytes,
            stage_capacity_bytes=cap_bytes, spill_bytes=sum(host_bytes),
            devices=tuple(s.device.name for s in stages),
            replicas=tuple(s.replicas for s in stages),
            cost_source=cost_source, trace_stage_times_s=trace_times,
            stage_time_error_pct=err_pct,
            **({k: (tuple(v) if isinstance(v, (list, tuple)) else v)
                for k, v in decode.items()} if decode else {}))

    def describe(self) -> str:
        """One-line report summary for logs."""
        head = (f"{self.graph_name} / {self.strategy} x{self.n_stages}"
                + (f" ({self.n_devices} devs)"
                   if self.n_devices != self.n_stages else ""))
        if self.bottleneck_stage < 0:
            return f"{head}: no modeled times"
        mib = self.spill_bytes / (1024 * 1024)
        line = (f"{head}: pacing S{self.bottleneck_stage}"
                f"={self.max_stage_time_s*1e3:.3f} ms, time imbalance "
                f"{self.imbalance_time_pct:.1f}%, "
                f"Δs={self.imbalance_params/1e6:.2f}M, "
                f"spill {mib:.2f} MiB")
        if self.cost_source != "analytic":
            line += f" [{self.cost_source}]"
        if self.has_trace:
            line += f" (vs trace: {self.stage_time_error_pct:.1f}% err)"
        if self.is_decode:
            line += (f" | decode {self.decode_tokens_per_s:.1f} tok/s "
                     f"@ c={self.decode_concurrency}"
                     f"/ctx={self.decode_max_context}, KV headroom "
                     f"{self.kv_headroom_pct:.0f}%")
        return line

    # -- (de)serialization ---------------------------------------------------
    def to_dict(self) -> Dict:
        doc = dataclasses.asdict(self)
        doc["format"] = REPORT_FORMAT
        for key, val in list(doc.items()):
            if isinstance(val, tuple):
                doc[key] = list(val)
        return doc

    @classmethod
    def from_dict(cls, doc: Dict) -> "PlanReport":
        doc = dict(doc)
        fmt = doc.pop("format", REPORT_FORMAT)
        if fmt != REPORT_FORMAT:
            raise ValueError(f"not a plan report document: {fmt!r}")
        for f in dataclasses.fields(cls):
            if f.name in doc and isinstance(doc[f.name], list):
                doc[f.name] = tuple(doc[f.name])
        return cls(**doc)

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "PlanReport":
        return cls.from_dict(json.loads(text))
