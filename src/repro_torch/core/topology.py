"""Device topology abstraction: heterogeneous device specs for placement.

The paper assumes a linear chain of *identical* Edge TPUs, so its plan is a
bare cut list.  DistrEdge-style distributed-edge setups (PAPERS.md, arXiv
2202.01699) break both assumptions: devices differ (on-chip memory, compute
rate, link bandwidth) and a bottleneck stage may be *replicated* across
several devices.  This module provides the vocabulary the
:class:`~repro_torch.core.placement.PlacementPlan` hand-off needs:

* :class:`DeviceSpec` — one device, expressed as deltas against the
  calibrated :class:`~repro_torch.core.edge_tpu_model.EdgeTPUSpec` (memory
  capacity override + compute / stream-bandwidth scale factors).  The
  default spec is the paper's device bit-for-bit: ``specialize`` returns
  the base spec object unchanged, so homogeneous plans price segments with
  the exact same floats as before.
* :class:`Topology` — an ordered chain of devices (the pipeline order).
  Stages consume consecutive runs of devices; a replicated stage consumes
  ``k`` *identical* consecutive devices (round-robin fan-out needs equal
  service rates for an even split).
* :class:`TopologyCostModel` — per-device segment pricing.  One
  :class:`~repro_torch.core.cost_engine.SegmentCostEngine` per distinct device
  spec, all sharing the graph-side precomputes (prefix sums, sparse table,
  flat layer order) via :meth:`SegmentCostEngine.with_spec`, so adding a
  device class costs O(1) — not another O(L) rebuild.

Replication time model (the planner's rule): a stage replicated over ``k``
devices serves ``1/k`` of the traffic per device, so its *pacing* time
divides by ``k`` — except the systolic-array weight-load term, which every
replica pays per inference it serves and which therefore does not amortize:

    eff(seg, k) = t_weight_load(seg) + (t_stage(seg) - t_weight_load(seg)) / k

``k = 1`` returns ``t_stage`` exactly (no float re-association), keeping
no-replica plans bit-identical to the plain planner.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .cost_engine import SegmentCostEngine
from .edge_tpu_model import EdgeTPUModel, EdgeTPUSpec
from .graph import LayerGraph

MIB = 1024 * 1024


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One accelerator, as deltas against the calibrated Edge TPU spec.

    * ``onchip_bytes`` — on-chip memory capacity; ``None`` keeps the base
      spec's (8 MiB for the paper's device).
    * ``compute_scale`` — multiplies MAC throughput *and* the systolic
      weight-load rate (a wider array fills faster too).
    * ``bandwidth_scale`` — multiplies the host link (PCIe) rate used for
      streamed weights and stage I/O.
    """

    name: str = "edgetpu-v1"
    onchip_bytes: Optional[int] = None
    compute_scale: float = 1.0
    bandwidth_scale: float = 1.0

    @property
    def is_reference(self) -> bool:
        """True when this device is the base spec unchanged."""
        return (self.onchip_bytes is None and self.compute_scale == 1.0
                and self.bandwidth_scale == 1.0)

    def specialize(self, base: EdgeTPUSpec) -> EdgeTPUSpec:
        """Concrete per-device spec.  Reference devices return ``base``
        itself so homogeneous pricing stays bit-identical."""
        if self.is_reference:
            return base
        return dataclasses.replace(
            base,
            onchip_bytes=(base.onchip_bytes if self.onchip_bytes is None
                          else self.onchip_bytes),
            mac_efficiency=base.mac_efficiency * self.compute_scale,
            weight_load_gbps=base.weight_load_gbps * self.compute_scale,
            pcie_gbps=base.pcie_gbps * self.bandwidth_scale,
        )

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "DeviceSpec":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class Topology:
    """An ordered chain of devices — the pipeline runs through them in
    order; stage ``i`` occupies a consecutive run of ``replicas[i]``
    devices."""

    devices: Tuple[DeviceSpec, ...]
    name: str = "chain"

    def __post_init__(self):
        if not self.devices:
            raise ValueError("topology needs at least one device")
        object.__setattr__(self, "devices", tuple(self.devices))

    @classmethod
    def homogeneous(cls, n: int, device: Optional[DeviceSpec] = None,
                    name: str = "chain") -> "Topology":
        dev = device if device is not None else DeviceSpec()
        return cls(devices=(dev,) * n, name=name)

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    @property
    def is_homogeneous(self) -> bool:
        return all(d == self.devices[0] for d in self.devices)

    def can_group(self, dev_lo: int, k: int) -> bool:
        """Replica groups must be identical consecutive devices (round-robin
        fan-out splits traffic evenly, which needs equal service rates)."""
        group = self.devices[dev_lo:dev_lo + k]
        return len(group) == k and all(d == group[0] for d in group)

    def describe(self) -> str:
        runs: List[Tuple[DeviceSpec, int]] = []
        for d in self.devices:
            if runs and runs[-1][0] == d:
                runs[-1] = (d, runs[-1][1] + 1)
            else:
                runs.append((d, 1))
        return " + ".join(f"{k}x{d.name}" if k > 1 else d.name
                          for d, k in runs)


class TopologyCostModel:
    """Per-device segment pricing over one graph.

    Builds one :class:`SegmentCostEngine` per *distinct* device spec; all
    engines share the graph precomputes of the base engine (per-stage
    device limits without per-stage O(L) rebuilds).  This is the
    "per-stage device limits instead of one global ``tpu_mem_bytes``"
    object: each stage's memory capacity and time constants come from the
    device the placement assigns it.  ``cost_source`` (a
    :class:`~repro.profiling.sources.CostSource`) threads through to
    every per-device engine — a trace-backed source re-materializes its
    per-depth times per device class, scaled by the device's compute
    rate.
    """

    def __init__(self, graph: LayerGraph, topology: Topology,
                 base_spec: Optional[EdgeTPUSpec] = None, cost_source=None):
        self.graph = graph
        self.topology = topology
        self.base_model = EdgeTPUModel(graph, base_spec,
                                       cost_source=cost_source)
        self._engines: Dict[DeviceSpec, SegmentCostEngine] = {}

    def engine_for(self, device: DeviceSpec) -> SegmentCostEngine:
        eng = self._engines.get(device)
        if eng is None:
            spec = device.specialize(self.base_model.spec)
            base_engine = self.base_model.engine
            eng = (base_engine if spec is self.base_model.spec
                   else base_engine.with_spec(spec))
            self._engines[device] = eng
        return eng

    # -- per-device segment terms -------------------------------------------
    def stage_time(self, device: DeviceSpec, lo: int, hi: int) -> float:
        return self.engine_for(device).segment_time(lo, hi)

    def weight_load_time(self, device: DeviceSpec, lo: int, hi: int) -> float:
        return self.engine_for(device).segment_weight_load_time(lo, hi)

    def stage_host_bytes(self, device: DeviceSpec, lo: int, hi: int) -> int:
        return self.engine_for(device).segment_host_bytes(lo, hi)

    def effective_time(self, device: DeviceSpec, lo: int, hi: int,
                       replicas: int) -> float:
        """Pacing time of the segment on ``replicas`` copies of ``device``
        (weight-load does not amortize; see module docstring)."""
        t = self.stage_time(device, lo, hi)
        if replicas <= 1:
            return t
        t_w = self.weight_load_time(device, lo, hi)
        return t_w + (t - t_w) / replicas

    # -- planner hooks -------------------------------------------------------
    def placement_cost_fn(self):
        """``cost(lo, hi, dev_lo, k)`` for the joint cuts+replicas DP:
        +inf when the device run cannot form a replica group."""
        devices = self.topology.devices
        can_group = self.topology.can_group
        INF = float("inf")

        def cost(lo: int, hi: int, dev_lo: int, k: int) -> float:
            if k > 1 and not can_group(dev_lo, k):
                return INF
            return self.effective_time(devices[dev_lo], lo, hi, k)

        return cost

    def stage_reporters(self, devices: Sequence[DeviceSpec]):
        """One refine :class:`MemoryReporter` per stage, each bound to that
        stage's device limits."""
        from .refine import GraphReporter
        reporters = []
        for dev in devices:
            eng = self.engine_for(dev)
            reporters.append(GraphReporter(_EngineReporterAdapter(
                eng, self.graph)))
        return reporters


class _EngineReporterAdapter:
    """Duck-typed EdgeTPUModel stand-in for GraphReporter: exposes
    ``segment_report_bytes`` + ``graph`` + ``engine`` over a single
    engine (``engine`` lets the reporter share the cost source's
    per-depth bytes accounting)."""

    def __init__(self, engine: SegmentCostEngine, graph: LayerGraph):
        self._engine = engine
        self.engine = engine
        self.graph = graph

    def segment_report_bytes(self, lo: int, hi: int) -> Tuple[int, int]:
        return self._engine.segment_split(lo, hi)
