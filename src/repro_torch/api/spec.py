"""Declarative deployment description: the input to the one front door.

A :class:`DeploymentSpec` says *what* to deploy — which model graph, over
which devices, optimized how, under which constraints and serving policy —
without naming any of the machinery that does it.  ``repro_torch.api.plan`` turns
a spec into a :class:`~repro_torch.core.placement.PlacementPlan`;
``repro_torch.api.deploy`` turns it into a live :class:`~repro_torch.api.deploy.Deployment`.
DistrEdge (PAPERS.md, arXiv 2202.01699) frames multi-device CNN serving as
exactly this: one placement decision over a declarative description of
devices + model, not a hand-wired call sequence.

Specs are frozen (hashable, safe as cache keys — ``ElasticPlanner`` keys
its replan cache on them) and JSON-round-trippable (ship a deployment to a
fleet as a document; ``from_json(to_json(spec)) == spec`` exactly, floats
included).  Live Python objects (a prebuilt ``LayerGraph``, an
``EdgeTPUModel``) are *not* part of the spec: they are runtime overrides
passed alongside it to ``plan``/``deploy``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

from ..core.graph import LayerGraph
from ..core.topology import DeviceSpec, Topology

SPEC_FORMAT = "repro.deployment_spec/v1"


@dataclasses.dataclass(frozen=True)
class DeploymentSpec:
    """What to deploy, declaratively.

    Model / devices
    ---------------
    * ``model`` — graph reference resolvable without live objects:
      ``"cnn:<Name>"`` (a Table-1 model from ``repro.models.cnn.REAL_CNNS``),
      ``"synthetic-cnn:<f>"`` (``synthetic_cnn(f)``), or
      ``"lm:<arch>[:seq=<n>]"`` (an LM smoke config's layer graph).  May be
      ``None`` when a live graph is passed to ``plan``/``deploy`` directly.
    * ``stages`` — pipeline stage count for homogeneous planning.  ``None``
      with no topology means *auto*: the paper's §5.2.2 rule (smallest
      count whose refined balanced plan avoids host memory).
    * ``topology`` / ``device_budget`` — heterogeneous device chain, or the
      homogeneous shorthand ``Topology.homogeneous(device_budget)``.  Used
      by the placement strategies; mutually exclusive.

    Objective / constraints
    -----------------------
    * ``strategy`` — a name in the strategy registry
      (:func:`repro_torch.api.available_strategies`).
    * ``objective`` — optional declared objective; validated against the
      chosen strategy's objective at plan time (catches "I asked for
      time balance but picked a params-balancing strategy" early).
    * ``refine`` — tri-state §6.1.3 refinement post-pass: ``None`` keeps
      the strategy's default, ``True``/``False`` forces it on/off (a
      strategy that cannot compose it — the joint ``placement`` DP —
      rejects ``True`` with a ValueError rather than ignoring it).
    * ``replicate`` / ``max_replicas`` — whether placement strategies may
      replicate a bottleneck stage across identical devices, and a cap.
    * ``memory_headroom_bytes`` — plan as if each device had this much
      less on-chip memory (deployment safety margin for runtime buffers).
    * ``prof_batch`` — batch size priced by the SEGM_PROF objective.
    * ``cost_source`` — where per-depth costs come from (the paper's
      plans are *profile-based*; see repro.profiling): ``"analytic"``
      (default: the closed-form device model, bit-identical to previous
      releases), ``"trace:<path>"`` (plan from a persisted
      :class:`~repro.profiling.trace.ProfileTrace`), or
      ``"calibrated:<path>"`` (the analytic model least-squares-fit to
      that trace).  Validated at construction; the trace file itself is
      read at plan time.

    Serving policy (consumed by :class:`~repro_torch.api.deploy.Deployment`)
    ------------------------------------------------------------------
    ``max_batch`` / ``max_wait_s`` (admission micro-batching),
    ``queue_size`` (inter-stage backpressure), ``microbatch`` /
    ``microbatch_wait_s`` (stage-level shape-bucketed dynamic
    micro-batching).

    ``backend`` — which execution tier ``Deployment.executor()`` builds:
    ``"host"`` (default; the threaded
    :class:`~repro_torch.core.pipeline.PipelineExecutor`, one worker per stage
    with queues between) or ``"spmd"`` (the
    :class:`~repro.launch.pipeline_spmd.SpmdPipelineExecutor`:
    shard_map/ppermute pipeline over a device mesh with overlapped weight
    streaming; needs one device per stage and an unreplicated plan —
    replicated plans fall back to the host executor with a logged
    notice).

    Fault policy (also serving-side): ``hedge_after`` — seconds before a
    straggling item on a replicated stage is speculatively re-dispatched
    to another replica (first result wins via the merge's dedup; ``None``
    — the default — disables hedging); ``stage_loss_retries`` — how many
    times a request that failed with ``StageLost`` (a whole stage died)
    is re-admitted, so it survives a degraded-mode replan (0 disables).

    Overload / self-healing policy (see EXPERIMENTS.md §Self-healing
    serving): ``deadline_ms`` — default per-request latency budget; a
    request past it completes with
    :class:`~repro_torch.serving.server.DeadlineExceeded` at admission or merge
    exit instead of waiting unbounded (``None`` disables).  ``shed_policy``
    — ``"deadline"`` enables admission control: requests whose estimated
    queue delay outlives the deadline budget are shed with
    :class:`~repro_torch.serving.server.Overloaded` + a jittered-backoff
    ``retry_after_s`` hint (``"none"`` disables).  ``drift_threshold`` —
    relative modeled-vs-observed per-stage time drift past which the
    self-healing controller (:class:`~repro.runtime.selfheal
    .SelfHealingController`) replans from live telemetry (0 disables the
    loop).  ``canary_requests`` — held-aside requests used to validate a
    candidate executor before a guarded reconfigure commits.

    Service-level objective (consumed by the fleet tier — see
    repro.fleet): ``slo_p95_ms`` — target p95 request latency; the fleet
    pool-split solver sizes this deployment's device allocation against
    it and the autoscaler treats an observed p95 past it as a violation.
    ``slo_throughput_rps`` — minimum sustained throughput the deployment
    must support (its modeled bottleneck pacing must stay under
    ``1/slo_throughput_rps``).  Both optional; a standalone deployment
    ignores them.

    Decode serving tier (see repro.decode / EXPERIMENTS.md §Decode
    serving): ``workload`` — ``"batch"`` (default; everything above) or
    ``"decode"``: steady-state autoregressive token generation.  Decode
    requires an ``lm:`` model ref, is planned at the
    ``(decode_concurrency, max_context)`` operating point (defaults in
    ``repro.decode.placement``), and ``Deployment.serve()`` returns a
    continuous-batching :class:`~repro.decode.engine.DecodeServer`
    streaming tokens instead of a request/response pipeline server.
    """

    model: Optional[str] = None
    stages: Optional[int] = None
    strategy: str = "balanced"
    objective: Optional[str] = None
    topology: Optional[Topology] = None
    device_budget: Optional[int] = None
    replicate: bool = True
    max_replicas: Optional[int] = None
    refine: Optional[bool] = None
    memory_headroom_bytes: int = 0
    prof_batch: int = 15
    cost_source: str = "analytic"
    # serving policy
    max_batch: int = 15
    max_wait_s: float = 0.02
    queue_size: int = 64
    microbatch: Optional[int] = None
    microbatch_wait_s: float = 0.0
    backend: str = "host"
    # fault policy
    hedge_after: Optional[float] = None
    stage_loss_retries: int = 0
    # overload / self-healing policy
    deadline_ms: Optional[float] = None
    shed_policy: str = "none"
    drift_threshold: float = 0.0
    canary_requests: int = 4
    # service-level objective (consumed by the fleet tier)
    slo_p95_ms: Optional[float] = None
    slo_throughput_rps: Optional[float] = None
    # decode serving tier (see repro.decode): workload="decode" plans with
    # the per-token cost regime at the (decode_concurrency, max_context)
    # operating point and serves via continuous batching
    workload: str = "batch"
    max_context: Optional[int] = None
    decode_concurrency: Optional[int] = None

    def __post_init__(self):
        if not self.strategy:
            raise ValueError("spec needs a strategy name")
        if self.stages is not None and self.stages < 1:
            raise ValueError(f"stages must be >= 1, got {self.stages}")
        if self.topology is not None and self.device_budget is not None:
            raise ValueError("topology and device_budget are mutually "
                             "exclusive (device_budget is the homogeneous "
                             "shorthand)")
        if self.device_budget is not None and self.device_budget < 1:
            raise ValueError(f"device_budget must be >= 1, "
                             f"got {self.device_budget}")
        if self.memory_headroom_bytes < 0:
            raise ValueError("memory_headroom_bytes must be >= 0")
        if self.hedge_after is not None and self.hedge_after <= 0:
            raise ValueError(f"hedge_after must be > 0, "
                             f"got {self.hedge_after}")
        if self.stage_loss_retries < 0:
            raise ValueError(f"stage_loss_retries must be >= 0, "
                             f"got {self.stage_loss_retries}")
        if self.backend not in ("host", "spmd"):
            raise ValueError(f"backend must be 'host' or 'spmd', "
                             f"got {self.backend!r}")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0 (or None), "
                             f"got {self.deadline_ms}")
        if self.shed_policy not in ("none", "deadline"):
            raise ValueError(f"shed_policy must be 'none' or 'deadline', "
                             f"got {self.shed_policy!r}")
        if self.shed_policy == "deadline" and self.deadline_ms is None:
            raise ValueError("shed_policy='deadline' needs deadline_ms "
                             "(the budget the queue-delay estimate is "
                             "compared against)")
        if self.drift_threshold < 0:
            raise ValueError(f"drift_threshold must be >= 0, "
                             f"got {self.drift_threshold}")
        if self.canary_requests < 1:
            raise ValueError(f"canary_requests must be >= 1, "
                             f"got {self.canary_requests}")
        if self.slo_p95_ms is not None and self.slo_p95_ms <= 0:
            raise ValueError(f"slo_p95_ms must be > 0 (or None), "
                             f"got {self.slo_p95_ms}")
        if (self.slo_throughput_rps is not None
                and self.slo_throughput_rps <= 0):
            raise ValueError(f"slo_throughput_rps must be > 0 (or None), "
                             f"got {self.slo_throughput_rps}")
        if self.workload not in ("batch", "decode"):
            raise ValueError(f"workload must be 'batch' or 'decode', "
                             f"got {self.workload!r}")
        if self.workload == "decode" and (
                self.model is None or not self.model.startswith("lm:")):
            raise ValueError(
                f"workload='decode' requires an 'lm:<arch>' model ref "
                f"(the decode regime is derived from the LM config); "
                f"got model={self.model!r}")
        if self.max_context is not None and self.max_context < 2:
            raise ValueError(f"max_context must be >= 2 (room for a prompt "
                             f"token and a generated token), "
                             f"got {self.max_context}")
        if self.decode_concurrency is not None and self.decode_concurrency < 1:
            raise ValueError(f"decode_concurrency must be >= 1, "
                             f"got {self.decode_concurrency}")
        from ..profiling.sources import parse_cost_source
        parse_cost_source(self.cost_source)   # raises on malformed refs

    # -- derived views -------------------------------------------------------
    def resolved_topology(self) -> Optional[Topology]:
        """The device chain the placement strategies plan over (homogeneous
        shorthand expanded), or None for plain stage-count planning."""
        if self.topology is not None:
            return self.topology
        if self.device_budget is not None:
            return Topology.homogeneous(self.device_budget)
        return None

    def with_stages(self, n: int) -> "DeploymentSpec":
        """Elastic-resize helper: the same deployment at a new device
        count (stage count for plain specs, budget for placement specs)."""
        if self.topology is not None:
            # devices leave from the tail of the chain (the pipeline order
            # is part of the topology's meaning)
            devs = self.topology.devices[:max(1, n)]
            return dataclasses.replace(
                self, topology=dataclasses.replace(self.topology,
                                                   devices=devs))
        if self.device_budget is not None:
            return dataclasses.replace(self, device_budget=max(1, n))
        return dataclasses.replace(self, stages=max(1, n))

    # -- (de)serialization ---------------------------------------------------
    def to_dict(self) -> Dict:
        doc = dataclasses.asdict(self)
        doc["format"] = SPEC_FORMAT
        if self.topology is not None:
            doc["topology"] = {
                "name": self.topology.name,
                "devices": [d.to_dict() for d in self.topology.devices],
            }
        return doc

    @classmethod
    def from_dict(cls, doc: Dict) -> "DeploymentSpec":
        doc = dict(doc)
        fmt = doc.pop("format", SPEC_FORMAT)
        if fmt != SPEC_FORMAT:
            raise ValueError(f"not a deployment spec document: {fmt!r}")
        topo = doc.get("topology")
        if topo is not None:
            doc["topology"] = Topology(
                devices=tuple(DeviceSpec.from_dict(d)
                              for d in topo["devices"]),
                name=topo.get("name", "chain"))
        return cls(**doc)

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "DeploymentSpec":
        return cls.from_dict(json.loads(text))


# ---------------------------------------------------------------------------
# model-reference resolution
# ---------------------------------------------------------------------------
def resolve_model_graph(model: str) -> LayerGraph:
    """Materialize the graph a spec's ``model`` string names.

    ``cnn:`` and ``synthetic-cnn:`` resolve through this package's CNN
    zoo (``models/cnn.py``); ``lm:`` through its own configs and
    ``lm_graph`` (the smoke config, as in the reference)."""
    kind, _, rest = model.partition(":")
    if not rest:
        raise ValueError(f"malformed model ref {model!r}; expected "
                         f"'cnn:<Name>', 'synthetic-cnn:<f>' or "
                         f"'lm:<arch>[:seq=<n>]'")
    if kind == "cnn":
        from ..models.cnn import REAL_CNNS
        if rest not in REAL_CNNS:
            raise ValueError(f"unknown CNN {rest!r}; pick from "
                             f"{sorted(REAL_CNNS)}")
        return REAL_CNNS[rest]().to_layer_graph()
    if kind == "synthetic-cnn":
        from ..models.cnn import synthetic_cnn
        return synthetic_cnn(int(rest)).to_layer_graph()
    if kind == "lm":
        arch, _, opt = rest.partition(":")
        seq = 64
        if opt:
            key, _, val = opt.partition("=")
            if key != "seq":
                raise ValueError(f"unknown lm option {opt!r} in {model!r}")
            seq = int(val)
        from .. import configs
        from ..models import lm_graph
        cfg = configs.get(arch).smoke_config()
        return lm_graph.lm_layer_graph(cfg, seq_len=seq)
    raise ValueError(f"unknown model ref kind {kind!r} in {model!r}")
