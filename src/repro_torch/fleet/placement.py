"""Global pool-split solver: partition one device pool across N models.

The paper's planner answers "given *k* devices, where do I cut *this*
CNN?" (the joint cuts+replicas DP behind strategy ``placement``).  The
fleet question is one level up: "given *D* devices and *N* models with
SLOs, how many devices does each model get?"  This module answers it
with a resource-allocation DP whose inner cost oracle is the existing
single-model planner — the same layering DistrEdge uses (per-model
placement inside, device partitioning outside).

Normalized cost.  Each candidate allocation (member *m* on *k* devices)
is priced by planning *m* on those *k* devices and folding the plan's
modeled bottleneck pacing ``b`` (max effective stage time) into an
SLO-normalized scalar::

    norm(m, b) = max( b / (slo_p95_ms / 1e3),      # latency attainment
                      b * slo_throughput_rps )      # pacing x required rate

(1.0 = exactly at SLO, < 1 = headroom; a member with no SLO falls back
to ``b * share`` — its share is read as relative demand).  The outer DP
then minimizes the *worst* member's norm — minimax over the fleet, the
fleet-level analogue of the paper's minimax over stages::

    f[i][d] = min over k of max(f[i-1][d-k], norm(i, d-k, k))

Allocations are contiguous prefixes of the pool chain (member order =
chain order), so a heterogeneous pool prices each member against the
actual devices it would own.  On a homogeneous pool the cost oracle is
keyed by (member, k) only.

Time-sliced co-residency.  When the pool is smaller than the fleet
(D < N) no partition exists; members are co-scheduled onto single
devices instead.  Under share-proportional time slicing a member's
effective bottleneck inflates to ``b_m / (s_m / S_G)`` where ``S_G`` is
the total share resident on its device; the greedy packer places
members (worst normalized demand first) onto the currently
least-loaded device, deterministically.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..api.deploy import plan as plan_one
from ..api.spec import DeploymentSpec, resolve_model_graph
from ..api.strategies import get_strategy
from ..core.graph import LayerGraph
from ..core.placement import PlacementPlan
from ..core.topology import Topology
from .spec import FleetMemberSpec, FleetSpec

_INF = float("inf")


def slo_norm(member: FleetMemberSpec, bottleneck_s: float) -> float:
    """SLO-normalized cost of running ``member`` at modeled bottleneck
    pacing ``bottleneck_s`` (1.0 = exactly at SLO; lower is headroom)."""
    spec = member.spec
    terms = []
    if spec.slo_p95_ms is not None:
        terms.append(bottleneck_s / (spec.slo_p95_ms / 1e3))
    if spec.slo_throughput_rps is not None:
        terms.append(bottleneck_s * spec.slo_throughput_rps)
    if not terms:
        terms.append(bottleneck_s * member.share)
    return max(terms)


def member_plan_spec(member: FleetMemberSpec,
                     devices: Topology) -> DeploymentSpec:
    """The member's spec pinned to a concrete device sub-chain.  Members
    whose strategy cannot plan over a topology are upgraded to the joint
    cuts+replicas DP (strategy ``placement``) — the fleet packs devices,
    so every inner plan must be topology-aware."""
    spec = member.spec
    if not get_strategy(spec.strategy).needs_topology:
        spec = dataclasses.replace(spec, strategy="placement",
                                   objective=None, refine=None)
    return dataclasses.replace(spec, topology=devices)


@dataclasses.dataclass(frozen=True)
class MemberAllocation:
    """One member's slice of the pool.

    ``device_indices`` are positions in the fleet pool chain.  In
    ``partitioned`` mode the member owns them exclusively and
    ``time_share`` is 1.0; in ``time_sliced`` mode the (single) device is
    shared and ``time_share`` is the member's share-proportional slice.
    ``bottleneck_s`` is the *effective* modeled pacing (time slicing
    already applied); ``norm_cost`` is :func:`slo_norm` of it.
    """

    name: str
    device_indices: Tuple[int, ...]
    plan: PlacementPlan
    bottleneck_s: float
    norm_cost: float
    mode: str = "partitioned"
    time_share: float = 1.0

    @property
    def n_devices(self) -> int:
        return len(self.device_indices)

    def summary(self) -> Dict:
        return {
            "name": self.name,
            "devices": list(self.device_indices),
            "n_stages": self.plan.n_stages,
            "replica_counts": list(self.plan.replica_counts),
            "bottleneck_s": self.bottleneck_s,
            "norm_cost": self.norm_cost,
            "mode": self.mode,
            "time_share": self.time_share,
        }


@dataclasses.dataclass(frozen=True)
class FleetPlacement:
    """The solved pool split: one :class:`MemberAllocation` per member."""

    fleet: FleetSpec
    allocations: Tuple[MemberAllocation, ...]
    mode: str                      # "partitioned" | "time_sliced"

    @property
    def worst_norm(self) -> float:
        return max(a.norm_cost for a in self.allocations)

    @property
    def worst_member(self) -> str:
        return max(self.allocations, key=lambda a: a.norm_cost).name

    def allocation(self, name: str) -> MemberAllocation:
        for a in self.allocations:
            if a.name == name:
                return a
        raise KeyError(f"no allocation for member {name!r}")

    def device_counts(self) -> Dict[str, int]:
        return {a.name: a.n_devices for a in self.allocations}

    def summary(self) -> Dict:
        return {
            "mode": self.mode,
            "pool_devices": self.fleet.pool().n_devices,
            "worst_norm": self.worst_norm,
            "worst_member": self.worst_member,
            "members": [a.summary() for a in self.allocations],
        }


class _CostOracle:
    """plan(member, contiguous device window) -> (norm, plan), cached.

    On a homogeneous pool the window's position is irrelevant and the
    cache key collapses to (member, width) — the DP then costs
    O(N * D) plans instead of O(N * D^2).
    """

    def __init__(self, fleet: FleetSpec, pool: Topology,
                 graphs: Dict[str, LayerGraph], tpu_model, base_spec):
        self.fleet = fleet
        self.pool = pool
        self.graphs = graphs
        self.tpu_model = tpu_model
        self.base_spec = base_spec
        self._cache: Dict[Tuple[int, int, int],
                          Tuple[float, Optional[PlacementPlan]]] = {}

    def cost(self, mi: int, start: int, k: int
             ) -> Tuple[float, Optional[PlacementPlan]]:
        key = (mi, 0, k) if self.pool.is_homogeneous else (mi, start, k)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        member = self.fleet.members[mi]
        sub = Topology(devices=self.pool.devices[start:start + k],
                       name=f"{member.name}[{k}]")
        try:
            pl = plan_one(member_plan_spec(member, sub),
                          graph=self.graphs[member.name],
                          tpu_model=self.tpu_model,
                          base_spec=self.base_spec, attach_report=False)
            b = pl.max_stage_time_s
            out = ((_INF, None) if b is None
                   else (slo_norm(member, b), pl))
        except ValueError:
            # infeasible window (e.g. replication disabled and more
            # devices than layers) — priced out, not fatal
            out = (_INF, None)
        self._cache[key] = out
        return out


def _resolve_graphs(fleet: FleetSpec,
                    graphs: Optional[Dict[str, LayerGraph]]
                    ) -> Dict[str, LayerGraph]:
    out = dict(graphs) if graphs else {}
    for m in fleet.members:
        if m.name not in out:
            out[m.name] = resolve_model_graph(m.spec.model)
    return out


def plan_fleet(fleet: FleetSpec, *,
               graphs: Optional[Dict[str, LayerGraph]] = None,
               tpu_model=None, base_spec=None,
               fixed_counts: Optional[Dict[str, int]] = None
               ) -> FleetPlacement:
    """Solve the global pool split for ``fleet``.

    ``graphs`` maps member name -> live :class:`LayerGraph`, overriding
    ``spec.model`` resolution (same contract as ``plan(spec, graph=)``).
    ``fixed_counts`` pins the split (member name -> device count, must
    sum to the pool) instead of solving it — the static-baseline mode
    benchmarks compare the solver against.  Returns a
    :class:`FleetPlacement`; raises ``ValueError`` when no feasible
    split exists.
    """
    pool = fleet.pool()
    members = fleet.members
    gmap = _resolve_graphs(fleet, graphs)
    if fixed_counts is not None:
        return _plan_fixed(fleet, pool, gmap, tpu_model, base_spec,
                           fixed_counts)
    if pool.n_devices < len(members):
        return _plan_time_sliced(fleet, pool, gmap, tpu_model, base_spec)

    oracle = _CostOracle(fleet, pool, gmap, tpu_model, base_spec)
    n, d_total = len(members), pool.n_devices
    lo = [m.min_devices for m in members]
    hi = [m.max_devices if m.max_devices is not None else d_total
          for m in members]
    # suffix_lo[i] = devices the members after i still need at minimum
    suffix_lo = [0] * (n + 1)
    for i in range(n - 1, -1, -1):
        suffix_lo[i] = suffix_lo[i + 1] + lo[i]

    # f[i][d]: best worst-norm covering members[:i] with the first d
    # pool devices; choice[i][d] the k that achieves it
    f = [[_INF] * (d_total + 1) for _ in range(n + 1)]
    choice = [[0] * (d_total + 1) for _ in range(n + 1)]
    f[0][0] = 0.0
    for i in range(1, n + 1):
        mi = i - 1
        for d in range(d_total + 1):
            best, best_k = _INF, 0
            # states whose remainder cannot hold the later members'
            # min_devices are dead ends — skip, don't price them
            if d + suffix_lo[i] <= d_total:
                for k in range(lo[mi], min(hi[mi], d) + 1):
                    if f[i - 1][d - k] == _INF:
                        continue
                    c, _ = oracle.cost(mi, d - k, k)
                    cand = max(f[i - 1][d - k], c)
                    if cand < best:
                        best, best_k = cand, k
            f[i][d] = best
            choice[i][d] = best_k
    # the last member absorbs the full remainder: every pool device is
    # owned by someone (idle devices are the autoscaler's slack, not
    # the solver's)
    if f[n][d_total] == _INF:
        raise ValueError(
            f"no feasible pool split: {d_total} devices across "
            f"{[m.name for m in members]} with min_devices={lo}, "
            f"max_devices={hi}")

    allocs: List[MemberAllocation] = []
    d = d_total
    for i in range(n, 0, -1):
        k = choice[i][d]
        start = d - k
        norm, pl = oracle.cost(i - 1, start, k)
        allocs.append(MemberAllocation(
            name=members[i - 1].name,
            device_indices=tuple(range(start, start + k)),
            plan=pl, bottleneck_s=pl.max_stage_time_s,
            norm_cost=norm, mode="partitioned"))
        d = start
    allocs.reverse()
    return FleetPlacement(fleet=fleet, allocations=tuple(allocs),
                          mode="partitioned")


def _plan_fixed(fleet: FleetSpec, pool: Topology,
                gmap: Dict[str, LayerGraph], tpu_model, base_spec,
                counts: Dict[str, int]) -> FleetPlacement:
    """Pinned split: price the given member -> device-count map as-is."""
    if set(counts) != set(fleet.member_names):
        raise ValueError("fixed_counts must cover exactly the fleet's "
                         "members")
    if sum(counts.values()) != pool.n_devices:
        raise ValueError(f"fixed_counts sum to {sum(counts.values())}, "
                         f"pool has {pool.n_devices} devices")
    if any(k < 1 for k in counts.values()):
        raise ValueError("fixed_counts must give every member >= 1 "
                         "device")
    oracle = _CostOracle(fleet, pool, gmap, tpu_model, base_spec)
    allocs: List[MemberAllocation] = []
    start = 0
    for mi, m in enumerate(fleet.members):
        k = counts[m.name]
        norm, pl = oracle.cost(mi, start, k)
        if pl is None:
            raise ValueError(f"member {m.name!r} cannot be planned on "
                             f"{k} devices")
        allocs.append(MemberAllocation(
            name=m.name, device_indices=tuple(range(start, start + k)),
            plan=pl, bottleneck_s=pl.max_stage_time_s,
            norm_cost=norm, mode="partitioned"))
        start += k
    return FleetPlacement(fleet=fleet, allocations=tuple(allocs),
                          mode="partitioned")


def _plan_time_sliced(fleet: FleetSpec, pool: Topology,
                      gmap: Dict[str, LayerGraph],
                      tpu_model, base_spec) -> FleetPlacement:
    """D < N fallback: co-schedule members onto single shared devices."""
    members = fleet.members
    base: List[Tuple[FleetMemberSpec, PlacementPlan, float]] = []
    for mi, m in enumerate(members):
        sub = Topology(devices=pool.devices[:1], name=f"{m.name}[1]")
        pl = plan_one(member_plan_spec(m, sub), graph=gmap[m.name],
                      tpu_model=tpu_model, base_spec=base_spec,
                      attach_report=False)
        b = pl.max_stage_time_s
        if b is None:
            raise ValueError(f"member {m.name!r}: cost model returned no "
                             f"stage times; time slicing needs them")
        base.append((m, pl, b))

    # worst normalized demand first onto the least-loaded device;
    # ties broken by member order (deterministic)
    order = sorted(range(len(members)),
                   key=lambda i: (-slo_norm(base[i][0], base[i][2]), i))
    loads = [0.0] * pool.n_devices
    groups: List[List[int]] = [[] for _ in range(pool.n_devices)]
    for i in order:
        di = min(range(pool.n_devices), key=lambda j: (loads[j], j))
        groups[di].append(i)
        loads[di] += base[i][0].share * base[i][2]

    allocs: List[Optional[MemberAllocation]] = [None] * len(members)
    for di, grp in enumerate(groups):
        total_share = sum(base[i][0].share for i in grp)
        for i in grp:
            m, pl, b = base[i]
            ts = m.share / total_share
            eff = b / ts
            allocs[i] = MemberAllocation(
                name=m.name, device_indices=(di,), plan=pl,
                bottleneck_s=eff, norm_cost=slo_norm(m, eff),
                mode="time_sliced", time_share=ts)
    return FleetPlacement(fleet=fleet, allocations=tuple(allocs),
                          mode="time_sliced")
