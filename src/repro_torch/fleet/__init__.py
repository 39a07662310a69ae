"""Multi-tenant serving fleet: N models on one shared device pool.

The paper balances *one* CNN's segments across a fixed set of Edge TPUs;
this package is the many-workloads extension (DistrEdge's framing): pack several :class:`~repro_torch.core.placement
.PlacementPlan`s onto one :class:`~repro_torch.core.topology.Topology` so every
model meets its SLO.

* :mod:`repro_torch.fleet.spec` — :class:`FleetSpec` / :class:`FleetMemberSpec`:
  the frozen, JSON-round-trippable description of N member deployments
  with per-model SLOs over one shared pool.
* :mod:`repro_torch.fleet.placement` — the global pool-split solver:
  a resource-allocation DP over the member-count x device-count grid
  whose inner cost is the existing joint cuts+replicas planner, plus the
  time-sliced co-residency fallback for pools smaller than the fleet.
* :mod:`repro_torch.fleet.router` — the admission front door: one
  ``submit(model, payload)`` entry, deficit-round-robin weighted fair
  queueing on member ``share``, per-model deadline/shed reusing the
  server's ``DeadlineExceeded`` / ``Overloaded`` machinery.
* :mod:`repro_torch.fleet.autoscale` — the SLO-headroom autoscaler: folds each
  member's ``snapshot()`` telemetry into headroom and moves devices from
  over-provisioned members to violating ones through the existing
  ``ElasticPlanner.resize_server`` -> ``reconfigure()`` hot-swap path,
  guarded (commit-or-rollback + cooldown, never below one device).
* :mod:`repro_torch.fleet.deploy` — the :class:`Fleet` runtime handle
  (``deploy_fleet(spec) -> Fleet``), mirroring ``repro_torch.api.Deployment``.
* :mod:`repro_torch.fleet.scenario` — a synthetic traffic generator, run by
  ``launch/serve.py --fleet``.
"""
from .autoscale import AutoscalePolicy, FleetAutoscaler
from .deploy import Fleet, deploy_fleet
from .placement import FleetPlacement, MemberAllocation, plan_fleet
from .router import FleetRouter
from .spec import FLEET_SPEC_FORMAT, FleetMemberSpec, FleetSpec

__all__ = [
    "AutoscalePolicy", "Fleet", "FleetAutoscaler", "FleetMemberSpec",
    "FleetPlacement", "FleetRouter", "FleetSpec", "FLEET_SPEC_FORMAT",
    "MemberAllocation", "deploy_fleet", "plan_fleet",
]
