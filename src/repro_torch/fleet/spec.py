"""Declarative fleet description: N member deployments, one device pool.

A :class:`FleetSpec` is to the fleet what
:class:`~repro_torch.api.spec.DeploymentSpec` is to one model: frozen (hashable,
safe as a cache key), JSON-round-trippable (``from_json(to_json(f)) == f``
exactly), and free of live Python objects — graphs and stage-function
builders are runtime overrides passed to ``repro_torch.fleet.deploy_fleet``.

Each :class:`FleetMemberSpec` names one model deployment (a full nested
``DeploymentSpec`` — model ref, strategy, serving/fault policy, and the
SLO fields ``slo_p95_ms`` / ``slo_throughput_rps``) plus the fleet-level
knobs that have no meaning standalone: the weighted-fair-queueing
``share`` and the member's device-count bounds for the autoscaler.

The member spec must leave its device shape open (``stages`` /
``topology`` / ``device_budget`` unset): the pool-split solver decides
how many of the *fleet's* devices each member gets — a member that pins
its own shape has opted out of the one decision the fleet exists to make.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

from ..api.spec import DeploymentSpec
from ..core.topology import DeviceSpec, Topology

FLEET_SPEC_FORMAT = "repro.fleet_spec/v1"


@dataclasses.dataclass(frozen=True)
class FleetMemberSpec:
    """One fleet member: a deployment spec plus its fleet-level policy.

    * ``name`` — the routing key (``Fleet.submit(name, payload)``); unique
      within the fleet.
    * ``spec`` — the member's :class:`DeploymentSpec`.  Its SLO fields
      drive the pool split and the autoscaler; its serving policy
      (deadline, shedding, micro-batching) applies unchanged to the
      member's own server.
    * ``share`` — weighted-fair-queueing weight (deficit round-robin
      quantum is proportional to it) and the demand prior the pool-split
      solver falls back to when a member declares no SLO.
    * ``min_devices`` / ``max_devices`` — autoscaler bounds; the fleet
      never resizes a member below ``min_devices`` (floor 1) or above
      ``max_devices`` (``None`` = unbounded).
    """

    name: str
    spec: DeploymentSpec
    share: float = 1.0
    min_devices: int = 1
    max_devices: Optional[int] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("fleet member needs a name (the routing key)")
        if self.spec.model is None:
            raise ValueError(f"member {self.name!r}: spec needs a model "
                             f"ref (the fleet resolves graphs from it)")
        if self.share <= 0:
            raise ValueError(f"member {self.name!r}: share must be > 0, "
                             f"got {self.share}")
        if self.min_devices < 1:
            raise ValueError(f"member {self.name!r}: min_devices must be "
                             f">= 1, got {self.min_devices}")
        if (self.max_devices is not None
                and self.max_devices < self.min_devices):
            raise ValueError(f"member {self.name!r}: max_devices "
                             f"({self.max_devices}) < min_devices "
                             f"({self.min_devices})")
        if (self.spec.stages is not None
                or self.spec.topology is not None
                or self.spec.device_budget is not None):
            raise ValueError(
                f"member {self.name!r}: spec must leave stages/topology/"
                f"device_budget unset — the fleet's pool-split solver "
                f"assigns the device shape")

    def to_dict(self) -> Dict:
        return {
            "name": self.name,
            "spec": self.spec.to_dict(),
            "share": self.share,
            "min_devices": self.min_devices,
            "max_devices": self.max_devices,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "FleetMemberSpec":
        d = dict(d)
        d["spec"] = DeploymentSpec.from_dict(d["spec"])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """N member deployments over one shared device pool.

    Pool
    ----
    * ``topology`` / ``device_budget`` — the shared device chain, or the
      homogeneous shorthand ``Topology.homogeneous(device_budget)``;
      mutually exclusive, exactly one required.

    Autoscaler policy (consumed by :class:`~repro_torch.fleet.autoscale
    .FleetAutoscaler`; every knob also overridable via an explicit
    ``AutoscalePolicy``)
    ---------------------------------------------------------------
    * ``rebalance_cooldown_windows`` — observation windows suppressed
      after any device move (the moved pair needs fresh telemetry, and
      the guard verdict is read at the end of the cooldown).
    * ``rebalance_headroom`` — a donor must keep at least this much
      modeled SLO headroom (attainment ratio) after giving up a device;
      > 1 biases toward stability over perfect packing.
    """

    members: Tuple[FleetMemberSpec, ...] = ()
    topology: Optional[Topology] = None
    device_budget: Optional[int] = None
    rebalance_cooldown_windows: int = 2
    rebalance_headroom: float = 1.2

    def __post_init__(self):
        object.__setattr__(self, "members", tuple(self.members))
        if not self.members:
            raise ValueError("fleet needs at least one member")
        names = [m.name for m in self.members]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate member names: {dupes}")
        if (self.topology is None) == (self.device_budget is None):
            raise ValueError("fleet needs exactly one of topology or "
                             "device_budget (the shared pool)")
        if self.device_budget is not None and self.device_budget < 1:
            raise ValueError(f"device_budget must be >= 1, "
                             f"got {self.device_budget}")
        if self.rebalance_cooldown_windows < 0:
            raise ValueError("rebalance_cooldown_windows must be >= 0")
        if self.rebalance_headroom <= 0:
            raise ValueError("rebalance_headroom must be > 0")
        floor = sum(m.min_devices for m in self.members)
        pool = self.pool().n_devices
        # a pool smaller than the member count is legal (time-sliced
        # co-residency) but the declared per-member floors must fit the
        # partitioned mode they apply to
        if pool >= len(self.members) and floor > pool:
            raise ValueError(
                f"sum of member min_devices ({floor}) exceeds the pool "
                f"({pool} devices)")

    # -- derived views -------------------------------------------------------
    def pool(self) -> Topology:
        """The shared device chain (homogeneous shorthand expanded)."""
        if self.topology is not None:
            return self.topology
        return Topology.homogeneous(self.device_budget, name="pool")

    def member(self, name: str) -> FleetMemberSpec:
        for m in self.members:
            if m.name == name:
                return m
        raise KeyError(f"no fleet member {name!r}; members: "
                       f"{[m.name for m in self.members]}")

    @property
    def member_names(self) -> Tuple[str, ...]:
        return tuple(m.name for m in self.members)

    @property
    def total_share(self) -> float:
        return sum(m.share for m in self.members)

    # -- (de)serialization ---------------------------------------------------
    def to_dict(self) -> Dict:
        doc = {
            "format": FLEET_SPEC_FORMAT,
            "members": [m.to_dict() for m in self.members],
            "topology": None,
            "device_budget": self.device_budget,
            "rebalance_cooldown_windows": self.rebalance_cooldown_windows,
            "rebalance_headroom": self.rebalance_headroom,
        }
        if self.topology is not None:
            doc["topology"] = {
                "name": self.topology.name,
                "devices": [d.to_dict() for d in self.topology.devices],
            }
        return doc

    @classmethod
    def from_dict(cls, doc: Dict) -> "FleetSpec":
        doc = dict(doc)
        fmt = doc.pop("format", FLEET_SPEC_FORMAT)
        if fmt != FLEET_SPEC_FORMAT:
            raise ValueError(f"not a fleet spec document: {fmt!r}")
        topo = doc.get("topology")
        if topo is not None:
            doc["topology"] = Topology(
                devices=tuple(DeviceSpec.from_dict(d)
                              for d in topo["devices"]),
                name=topo.get("name", "pool"))
        doc["members"] = tuple(FleetMemberSpec.from_dict(m)
                               for m in doc.get("members", ()))
        return cls(**doc)

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "FleetSpec":
        return cls.from_dict(json.loads(text))
