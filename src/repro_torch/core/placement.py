"""The plan hand-off types: ``StagePlacement`` / ``PlacementPlan``.

The plan is the single hand-off object between the paper's algorithms and
the executors: the host-threaded pipeline (core/pipeline.py), the SPMD
pipeline (launch/pipeline_spmd.py), and the benchmarks all consume a plan.

A bare cut list (``SegmentationPlan``) implies one identical device per
stage.  The hand-off is a :class:`PlacementPlan`: an ordered
list of :class:`StagePlacement` records, each carrying its depth range, its
assigned :class:`~repro_torch.core.topology.DeviceSpec`, and a **replica count**
(a bottleneck stage may be replicated across k identical devices with
round-robin fan-out/fan-in in the executor).  ``PlacementPlan.from_cuts``
is the thin compatibility constructor: homogeneous no-replica plans carry
the exact cuts and modeled stage times the cut-list plans did.
``SegmentationPlan`` remains as a deprecated alias.

This module is the canonical import location for the plan types (it also
keeps the stage-count rules ``min_stages_to_fit`` / ``min_stages_no_spill``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .edge_tpu_model import EdgeTPUModel
from .graph import LayerGraph
from .refine import RefinementResult
from .segmentation import segment_ranges, segment_sums
from .topology import DeviceSpec


@dataclasses.dataclass
class StagePlacement:
    """One pipeline stage: a depth range placed on a device, possibly
    replicated.

    ``time_s`` is the modeled per-inference latency of the segment on ONE
    copy of ``device`` (the analytical Edge TPU model); the *pacing* time
    under replication is :attr:`effective_time_s` — the weight-load term
    does not amortize across replicas (every replica re-fills its systolic
    array per inference it serves), the rest divides by ``replicas``.
    """

    depth_lo: int
    depth_hi: int
    layers: List[str]
    params: int
    device: DeviceSpec = dataclasses.field(default_factory=DeviceSpec)
    replicas: int = 1
    time_s: Optional[float] = None
    weight_load_s: Optional[float] = None

    @property
    def depth_range(self) -> Tuple[int, int]:
        return (self.depth_lo, self.depth_hi)

    @property
    def effective_time_s(self) -> Optional[float]:
        if self.time_s is None:
            return None
        if self.replicas <= 1:
            return self.time_s
        if self.weight_load_s is None:
            return None    # cannot amortize without the non-amortizing term
        t_w = self.weight_load_s
        return t_w + (self.time_s - t_w) / self.replicas

    def to_dict(self) -> Dict:
        return {
            "depth_lo": self.depth_lo, "depth_hi": self.depth_hi,
            "layers": list(self.layers), "params": self.params,
            "device": self.device.to_dict(), "replicas": self.replicas,
            "time_s": self.time_s, "weight_load_s": self.weight_load_s,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "StagePlacement":
        d = dict(d)
        d["device"] = DeviceSpec.from_dict(d["device"])
        return cls(**d)


@dataclasses.dataclass
class PlacementPlan:
    """Ordered stage placements for a model pipeline.

    The compatibility surface of the old cut-list plan is preserved as
    properties (``cuts``, ``stage_depth_ranges``, ``stage_layers``,
    ``stage_params``, ``n_stages``), so code that only cares about where
    the cuts fall keeps working; replication-aware consumers read
    ``stages`` / ``replica_counts`` / ``n_devices``.
    """

    graph_name: str
    strategy: str
    stages: List[StagePlacement]
    refinement: Optional[RefinementResult] = None
    # modeled quality/memory record (repro_torch.api.PlanReport); attached by the
    # repro_torch.api front door, carried through JSON round-trips
    report: Optional[Any] = None

    # -- compatibility surface (cut-list view) ------------------------------
    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def n_devices(self) -> int:
        return sum(s.replicas for s in self.stages)

    @property
    def cuts(self) -> List[int]:
        return [s.depth_hi for s in self.stages[:-1]]

    @property
    def stage_depth_ranges(self) -> List[tuple]:
        return [(s.depth_lo, s.depth_hi) for s in self.stages]

    @property
    def stage_layers(self) -> List[List[str]]:
        return [s.layers for s in self.stages]

    @property
    def stage_params(self) -> List[int]:
        return [s.params for s in self.stages]

    @property
    def replica_counts(self) -> List[int]:
        return [s.replicas for s in self.stages]

    @property
    def stage_times_s(self) -> List[Optional[float]]:
        """Modeled per-inference stage times on one device each."""
        return [s.time_s for s in self.stages]

    @property
    def effective_stage_times_s(self) -> List[Optional[float]]:
        """Pacing times with replication amortization applied."""
        return [s.effective_time_s for s in self.stages]

    @property
    def max_stage_time_s(self) -> Optional[float]:
        eff = [t for t in self.effective_stage_times_s if t is not None]
        return max(eff) if eff else None

    @property
    def imbalance(self) -> int:
        """Δs (paper Table 5): largest minus smallest stage, in params."""
        return max(self.stage_params) - min(self.stage_params)

    def describe(self) -> str:
        """One-line plan summary.

        Homogeneous, no-replica plan (the paper's shape)::

            resnet50 / opt x4: S0[d0-17]=6.31M, ... (Δs=1.05M)

        Replicated / heterogeneous placements annotate stages with the
        device and replica count::

            resnet50 / opt_placement x3 (5 devs): S0[d0-17]=6.31M,
            S1[d18-29]=8.1M@edgetpu-v1x3, S2[d30-52]=7.9M (Δs=1.79M)
        """
        segs = []
        for i, st in enumerate(self.stages):
            tag = ""
            if not st.device.is_reference:
                tag += f"@{st.device.name}"
            if st.replicas > 1:
                tag = (tag or f"@{st.device.name}") + f"x{st.replicas}"
            segs.append(f"S{i}[d{st.depth_lo}-{st.depth_hi}]"
                        f"={st.params/1e6:.2f}M{tag}")
        head = f"{self.graph_name} / {self.strategy} x{self.n_stages}"
        if self.n_devices != self.n_stages:
            head += f" ({self.n_devices} devs)"
        return f"{head}: {', '.join(segs)} (Δs={self.imbalance/1e6:.2f}M)"

    # -- construction --------------------------------------------------------
    @classmethod
    def from_cuts(
        cls,
        graph: LayerGraph,
        cuts: Sequence[int],
        strategy: str = "manual",
        device: Optional[DeviceSpec] = None,
        replicas: Optional[Sequence[int]] = None,
        devices: Optional[Sequence[DeviceSpec]] = None,
        tpu_model: Optional[EdgeTPUModel] = None,
        refinement: Optional[RefinementResult] = None,
    ) -> "PlacementPlan":
        """Thin compatibility constructor: a cut list over ``graph``
        becomes a placement on homogeneous reference devices (one per
        stage, no replication) unless per-stage ``devices`` / ``replicas``
        say otherwise.  Modeled stage times come from ``tpu_model`` (or a
        default :class:`EdgeTPUModel`) — on the default device they are
        bit-identical to the cut-list planner's, since the same engine
        prices the same segments."""
        d = graph.depth
        ranges = segment_ranges(d, cuts)
        s = len(ranges)
        dev_list = (list(devices) if devices is not None
                    else [device if device is not None else DeviceSpec()] * s)
        rep_list = list(replicas) if replicas is not None else [1] * s
        if len(dev_list) != s or len(rep_list) != s:
            raise ValueError(f"need {s} per-stage devices/replicas, got "
                             f"{len(dev_list)}/{len(rep_list)}")
        model = tpu_model or EdgeTPUModel(graph)
        # slice the cached levels (O(L) total) instead of re-scanning the
        # whole graph per stage (O(s * L))
        levels = graph.levels()
        P = graph.params_per_depth()
        params = segment_sums(P, cuts)
        stages = []
        for i, (lo, hi) in enumerate(ranges):
            dev = dev_list[i]
            eng = (model.engine if dev.is_reference
                   else model.engine.with_spec(dev.specialize(model.spec)))
            stages.append(StagePlacement(
                depth_lo=lo, depth_hi=hi,
                layers=[n for lvl in levels[lo:hi + 1] for n in lvl],
                params=params[i], device=dev, replicas=rep_list[i],
                time_s=eng.segment_time(lo, hi),
                weight_load_s=eng.segment_weight_load_time(lo, hi)))
        return cls(graph_name=graph.name, strategy=strategy, stages=stages,
                   refinement=refinement)

    # -- (de)serialization ---------------------------------------------------
    def to_json(self, indent: Optional[int] = None) -> str:
        """Persistable plan: benchmarks and serving ship plans instead of
        re-planning at startup."""
        doc = {
            "format": "repro.placement_plan/v1",
            "graph_name": self.graph_name,
            "strategy": self.strategy,
            "stages": [s.to_dict() for s in self.stages],
            "refinement": (None if self.refinement is None else {
                "cuts": list(self.refinement.cuts),
                "compilations": self.refinement.compilations,
                "moves": self.refinement.moves,
                "converged": self.refinement.converged,
            }),
            "report": (None if self.report is None
                       else self.report.to_dict()),
        }
        return json.dumps(doc, indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "PlacementPlan":
        doc = json.loads(text)
        fmt = doc.get("format")
        if fmt != "repro.placement_plan/v1":
            raise ValueError(f"not a placement plan document: {fmt!r}")
        ref = doc.get("refinement")
        rep = doc.get("report")
        if rep is not None:
            from ..api.report import PlanReport
            rep = PlanReport.from_dict(rep)
        return cls(
            graph_name=doc["graph_name"], strategy=doc["strategy"],
            stages=[StagePlacement.from_dict(s) for s in doc["stages"]],
            refinement=None if ref is None else RefinementResult(**ref),
            report=rep)


# deprecated alias: older consumers imported the cut-list plan by this name
SegmentationPlan = PlacementPlan


def min_stages_to_fit(graph: LayerGraph, capacity_bytes: int) -> int:
    """ceil(model_size / capacity): the paper's TPU-count rule (Table 5 note:
    'a model occupying S MiB has been fragmented into ceil(S/8) TPUs')."""
    total = graph.total_bytes
    return max(1, -(-total // capacity_bytes))


def min_stages_no_spill(graph: LayerGraph,
                        tpu_model: Optional[EdgeTPUModel] = None,
                        max_extra: int = 4) -> int:
    """The paper's working rule (§5.2.2): 'the minimum number of TPUs that
    would ideally avoid host memory usage' — smallest n whose refined
    balanced plan leaves every segment on-device."""
    from ..api import DeploymentSpec
    from ..api import plan as api_plan
    model = tpu_model or EdgeTPUModel(graph)
    start = min_stages_to_fit(graph, model.spec.onchip_bytes)
    for n in range(start, start + max_extra + 1):
        if n >= graph.depth:
            return n
        pl = api_plan(DeploymentSpec(stages=n, strategy="balanced"),
                      graph=graph, tpu_model=model, attach_report=False)
        if all(m.host_bytes == 0 for m in model.stage_memories(pl.cuts)):
            return n
    return start + max_extra
