"""The fleet runtime handle: ``deploy_fleet(spec) -> Fleet``.

Mirrors ``repro_torch.api.deploy`` one level up: :func:`deploy_fleet` solves
the pool split (:func:`~repro_torch.fleet.placement.plan_fleet`), builds one
:class:`~repro_torch.api.deploy.Deployment` per member on its slice of the
pool, serves them all, fronts them with the
:class:`~repro_torch.fleet.router.FleetRouter`, and wires the
:class:`~repro_torch.fleet.autoscale.FleetAutoscaler` over the lot.  The
:class:`Fleet` object owns every lifecycle underneath it — ``close()``
(or the context manager) tears down router, autoscaler, servers, and
deployments in order, so a fleet can never leak a member thread.

Stage functions come per member via ``stage_fn_builders`` (name ->
builder), same contract as ``deploy(stage_fn_builder=)`` — builders, not
fixed lists, because both the autoscaler and degraded-mode replans
change member stage shapes at runtime.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional

from ..api.deploy import Deployment, StageFnBuilder
from ..api.spec import DeploymentSpec, resolve_model_graph
from ..core.graph import LayerGraph
from ..core.topology import Topology
from ..serving.server import Request
from .autoscale import AutoscalePolicy, FleetAutoscaler
from .placement import FleetPlacement, member_plan_spec, plan_fleet
from .router import FleetRouter
from .spec import FleetSpec

logger = logging.getLogger(__name__)


class Fleet:
    """N live member deployments, one front door.

    Use :func:`deploy_fleet` to build one.  The interesting surface:

    * :meth:`submit` — route a request to a member (weighted-fair
      admission, per-member deadline/shed policy downstream).
    * :attr:`router` / :attr:`autoscaler` / :attr:`deployments` — the
      owned subsystems, exposed for observation and tests.
    * :meth:`snapshot` — router counters + per-member server snapshots
      + the current device split, one coherent view.
    * ``with fleet: ...`` / :meth:`close` — full teardown.
    """

    def __init__(self, spec: FleetSpec, placement: FleetPlacement,
                 deployments: Dict[str, Deployment],
                 router: FleetRouter,
                 autoscaler: Optional[FleetAutoscaler]):
        self.spec = spec
        self.placement = placement
        self.deployments = deployments
        self.router = router
        self.autoscaler = autoscaler
        self._closed = False

    # -- client API ----------------------------------------------------------
    def submit(self, model: str, payload: Any,
               deadline_s: Optional[float] = None,
               on_done: Optional[Callable[[Request], None]] = None
               ) -> Request:
        """Submit a request for ``model`` through the admission router.
        Returns a :class:`~repro_torch.serving.server.Request` future; wait on
        ``req.event`` and read ``req.result`` / ``req.error`` (or pass
        ``on_done``, installed race-free before dispatch)."""
        if self._closed:
            raise RuntimeError("fleet is closed")
        return self.router.submit(model, payload, deadline_s=deadline_s,
                                  on_done=on_done)

    @property
    def member_names(self):
        return self.spec.member_names

    def device_counts(self) -> Dict[str, int]:
        """The live device split (the autoscaler mutates it; before any
        move it equals the solved placement's)."""
        if self.autoscaler is not None:
            return dict(self.autoscaler.device_counts)
        return self.placement.device_counts()

    def snapshot(self) -> Dict[str, Any]:
        """One coherent observability view: router counters, per-member
        server snapshot deltas (including their cumulative ``totals``),
        the live device split, and autoscaler events so far."""
        members = {}
        for name, dep in self.deployments.items():
            srv = dep.server
            members[name] = None if srv is None else srv.snapshot()
        return {
            "router": self.router.snapshot(),
            "members": members,
            "device_counts": self.device_counts(),
            "autoscaler_events": (list(self.autoscaler.events)
                                  if self.autoscaler is not None else []),
        }

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Tear down: router first (no new dispatches), then autoscaler,
        then every member deployment.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.router.stop()
        if self.autoscaler is not None:
            self.autoscaler.stop()
        for dep in self.deployments.values():
            dep.close()

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _member_runtime_spec(fleet: FleetSpec, name: str, *,
                         device_budget: Optional[int] = None,
                         topology: Optional[Topology] = None
                         ) -> DeploymentSpec:
    """The member's spec pinned to its slice of the pool.  Homogeneous
    slices pin ``device_budget`` (``with_stages`` then resizes it — the
    shape the autoscaler needs); heterogeneous slices pin the actual
    sub-chain."""
    base = member_plan_spec(fleet.member(name),
                            topology if topology is not None
                            else Topology.homogeneous(device_budget))
    if topology is not None:
        return base
    return dataclasses.replace(base, topology=None,
                               device_budget=device_budget)


def deploy_fleet(spec: FleetSpec, *,
                 graphs: Optional[Dict[str, LayerGraph]] = None,
                 stage_fn_builders: Dict[str, StageFnBuilder],
                 tpu_model=None, base_spec=None,
                 fixed_counts: Optional[Dict[str, int]] = None,
                 autoscale: bool = True,
                 autoscale_policy: Optional[AutoscalePolicy] = None,
                 start: bool = True) -> Fleet:
    """Solve the pool split and bring the whole fleet up.

    ``graphs`` overrides ``spec.model`` resolution per member (same
    contract as ``plan(spec, graph=)``); ``stage_fn_builders`` maps
    member name -> stage-function builder (required — every member
    serves).  ``fixed_counts`` pins the pool split instead of solving it
    (the static-baseline mode).  ``autoscale=False`` skips the
    autoscaler; it is also
    skipped (with a log line) when the fleet shape cannot resize:
    time-sliced mode, a heterogeneous pool, or a single member.
    ``start=True`` starts every member's executor + admission loop and
    the router's dispatch thread (the autoscaler's thread is never
    auto-started — call ``fleet.autoscaler.start(interval_s)`` or drive
    ``tick()`` directly).
    """
    missing = [m.name for m in spec.members
               if m.name not in stage_fn_builders]
    if missing:
        raise ValueError(f"stage_fn_builders missing members: {missing}")
    gmap = dict(graphs) if graphs else {}
    for m in spec.members:
        if m.name not in gmap:
            gmap[m.name] = resolve_model_graph(m.spec.model)

    placement = plan_fleet(spec, graphs=gmap, tpu_model=tpu_model,
                           base_spec=base_spec, fixed_counts=fixed_counts)
    pool = spec.pool()
    homogeneous = pool.is_homogeneous

    deployments: Dict[str, Deployment] = {}
    try:
        for alloc in placement.allocations:
            name = alloc.name
            if placement.mode == "time_sliced" or homogeneous:
                dspec = _member_runtime_spec(
                    spec, name, device_budget=max(1, alloc.n_devices))
            else:
                sub = Topology(
                    devices=tuple(pool.devices[i]
                                  for i in alloc.device_indices),
                    name=f"{name}[{alloc.n_devices}]")
                dspec = _member_runtime_spec(spec, name, topology=sub)
            deployments[name] = Deployment(
                dspec, alloc.plan, graph=gmap[name],
                stage_fn_builder=stage_fn_builders[name],
                tpu_model=tpu_model, base_spec=base_spec)
            deployments[name].serve(start=start)

        router = FleetRouter(
            servers={n: (lambda d=dep: d.server)
                     for n, dep in deployments.items()},
            shares={m.name: m.share for m in spec.members},
            deadlines_s={m.name: (None if m.spec.deadline_ms is None
                                  else m.spec.deadline_ms / 1e3)
                         for m in spec.members})
        if start:
            router.start()

        autoscaler = None
        if autoscale:
            if placement.mode != "partitioned":
                logger.info("fleet autoscaler skipped: time-sliced mode "
                            "has no devices to move")
            elif not homogeneous:
                logger.info("fleet autoscaler skipped: heterogeneous "
                            "pool slices cannot resize by count")
            elif len(spec.members) < 2:
                logger.info("fleet autoscaler skipped: nothing to "
                            "rebalance with one member")
            else:
                autoscaler = FleetAutoscaler(
                    spec, deployments, placement.device_counts(),
                    policy=autoscale_policy)
        return Fleet(spec, placement, deployments, router, autoscaler)
    except Exception:
        for dep in deployments.values():
            dep.close()
        raise
