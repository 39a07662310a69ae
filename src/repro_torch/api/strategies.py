"""Pluggable plan-strategy registry: one name, one ``PlanStrategy``.

The Edge TPU evaluation the paper builds on (PAPERS.md, arXiv 2102.10423)
makes the case directly: the best segmentation policy is model- and
topology-dependent, so the policy must be *pluggable* — a registry entry,
not a hand-picked function import.  Every split/plan path is registered
here behind one call (:func:`repro_torch.api.plan`):

==================== ====================================================
name                 policy
==================== ====================================================
``comp``             SEGM_COMP — layer-count balanced (vendor model)
``prof``             SEGM_PROF — exhaustive search over the modeled
                     pipeline batch time (shallow models only)
``balanced``         SEGM_BALANCED — Algorithm 1 params split + §6.1.3
                     refinement (the paper's headline)
``balanced_norefine`` Algorithm 1 split only
``balanced_cost``    Algorithm 1 over modeled per-depth *time*, refined
``opt``              time-balanced minimax DP over modeled stage time,
                     never worse than ``balanced`` on max stage time
``placement``        joint cuts + replica-count DP over a device
                     topology (alias ``opt_placement``)
``balanced_placement`` params split + per-stage-device-limit refinement
                     over a topology, no replication search
==================== ====================================================

§6.1.3 refinement is a *composable post-pass*: each strategy declares a
default (``balanced`` refines, ``comp`` does not), and
``DeploymentSpec.refine`` overrides it either way.  With the default
tri-state (``None``) every strategy reproduces its legacy entry point
bit-for-bit — asserted over all 21 Table-1 models in
tests/test_deploy_api.py.

Registering a new policy::

    @register_strategy("my_policy")
    class MyStrategy(PlanStrategy):
        objective = "min_max_stage_time"
        def plan(self, ctx):
            cuts = my_split(ctx.graph, ctx.n_stages())
            return self.finish(ctx, cuts, model=ctx.model())
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Type

from ..core.edge_tpu_model import EdgeTPUModel, EdgeTPUSpec
from ..core.graph import LayerGraph
from ..core.placement import PlacementPlan
from ..core.refine import (GraphReporter, MemoryReporter, RefinementResult,
                           refine_cuts)
from ..core.segmentation import (balanced_split, comp_split,
                                 minimax_time_split, placement_split,
                                 prof_split)
from ..core.topology import Topology, TopologyCostModel
from .spec import DeploymentSpec


@dataclasses.dataclass
class PlanContext:
    """Everything a strategy may need at plan time: the declarative spec
    plus the runtime objects that cannot live in a JSON document (a
    prebuilt graph, a calibrated device model, a compiler-backed memory
    reporter, the LM config behind a caller's graph -- ``decode_placement``
    prices its KV rows, else the spec's ``lm:`` ref's smoke config)."""

    spec: DeploymentSpec
    graph: LayerGraph
    tpu_model: Optional[EdgeTPUModel] = None
    reporter: Optional[MemoryReporter] = None
    base_spec: Optional[EdgeTPUSpec] = None
    cfg: Optional[Any] = None
    _model: Optional[EdgeTPUModel] = dataclasses.field(
        default=None, repr=False)
    _cost_source: Optional[object] = dataclasses.field(
        default=None, repr=False)
    _cost_source_resolved: bool = dataclasses.field(
        default=False, repr=False)

    def cost_source(self):
        """A live cost source passed to ``plan(..., cost_source=)``, or
        None for the built-in analytic path.  The trace-backed spec kinds
        need the profiler, which is not ported yet."""
        if not self._cost_source_resolved:
            if self.spec.cost_source != "analytic":
                raise NotImplementedError(
                    f"cost_source={self.spec.cost_source!r}: trace-backed "
                    f"planning needs the profiler (profiling/), which is "
                    f"not ported to repro_torch yet; it is the profiler "
                    f"slice.  Use cost_source='analytic'")
            self._cost_source_resolved = True
        return self._cost_source

    def trace(self):
        """The ProfileTrace behind a trace-backed cost source (for the
        plan report's modeled-vs-measured columns), or None."""
        src = self.cost_source()
        return getattr(src, "trace", None)

    def device_base_spec(self) -> Optional[EdgeTPUSpec]:
        """Per-device constants with the spec's memory headroom applied.
        ``None`` (the default) keeps pricing bit-identical to the legacy
        paths — no spec object is even constructed."""
        base = self.base_spec
        headroom = self.spec.memory_headroom_bytes
        if headroom:
            base = base or EdgeTPUSpec()
            remaining = base.onchip_bytes - headroom
            if remaining <= 0:
                raise ValueError(
                    f"memory_headroom_bytes={headroom} consumes the whole "
                    f"on-chip capacity ({base.onchip_bytes} bytes) — every "
                    f"plan would spill; lower the headroom")
            base = dataclasses.replace(base, onchip_bytes=remaining)
        return base

    def model(self) -> EdgeTPUModel:
        """The device model strategies price against (explicit override
        wins — it may carry its own cost source; otherwise built once per
        context around the spec's cost source)."""
        if self.tpu_model is not None:
            return self.tpu_model
        if self._model is None:
            self._model = EdgeTPUModel(self.graph, self.device_base_spec(),
                                       cost_source=self.cost_source())
        return self._model

    def n_stages(self) -> int:
        """Spec stage count, or the paper's §5.2.2 auto rule (smallest
        count whose refined balanced plan avoids host memory)."""
        if self.spec.stages is not None:
            return self.spec.stages
        from ..core.placement import min_stages_no_spill
        return min_stages_no_spill(self.graph, self.model())

    def topology(self) -> Topology:
        topo = self.spec.resolved_topology()
        if topo is None:
            raise ValueError(
                f"strategy {self.spec.strategy!r} plans over a device "
                f"topology; set DeploymentSpec.topology or device_budget")
        return topo

    def child(self, strategy: str, n_stages: int,
              tpu_model: Optional[EdgeTPUModel] = None) -> "PlanContext":
        """Context for an internal sub-plan (e.g. ``opt``'s balanced
        baseline, or a placement strategy's homogeneous delegation)."""
        spec = dataclasses.replace(self.spec, strategy=strategy,
                                   stages=n_stages, topology=None,
                                   device_budget=None)
        return PlanContext(spec=spec, graph=self.graph,
                           tpu_model=tpu_model or self.tpu_model,
                           reporter=self.reporter,
                           base_spec=self.base_spec, cfg=self.cfg,
                           # share the resolved source: the child must not
                           # re-read the trace artifact from disk
                           _cost_source=self._cost_source,
                           _cost_source_resolved=self._cost_source_resolved)


class PlanStrategy:
    """One planning policy.  Subclass, set the class attributes, implement
    :meth:`plan`, and register with :func:`register_strategy`."""

    name: str = ""                      # filled in by register_strategy
    objective: str = "min_max_stage_time"
    default_refine: bool = False
    needs_topology: bool = False

    def plan(self, ctx: PlanContext) -> PlacementPlan:
        raise NotImplementedError

    # -- shared machinery ---------------------------------------------------
    def want_refine(self, ctx: PlanContext) -> bool:
        refine = ctx.spec.refine
        return self.default_refine if refine is None else refine

    def refine_pass(self, ctx: PlanContext, cuts: List[int],
                    model: Optional[EdgeTPUModel]
                    ) -> Tuple[List[int], Optional[EdgeTPUModel],
                               RefinementResult]:
        """§6.1.3 refinement as a post-pass: nudge cuts until no segment
        spills; keep the unrefined optimum if the refiner cannot converge
        (spill is unavoidable at this stage count)."""
        reporter = ctx.reporter
        if reporter is None:
            model = model or ctx.model()
            reporter = GraphReporter(model)
        refinement = refine_cuts(cuts, ctx.graph.depth, reporter)
        if refinement.converged:
            cuts = refinement.cuts
        return cuts, model, refinement

    def finish(self, ctx: PlanContext, cuts: List[int],
               model: Optional[EdgeTPUModel] = None,
               refinement: Optional[RefinementResult] = None,
               name: Optional[str] = None) -> PlacementPlan:
        if refinement is None and self.want_refine(ctx):
            cuts, model, refinement = self.refine_pass(ctx, cuts, model)
        return PlacementPlan.from_cuts(
            ctx.graph, cuts, strategy=name or self.name,
            tpu_model=model or ctx.tpu_model, refinement=refinement)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, PlanStrategy] = {}
_ALIASES: Dict[str, str] = {}


def register_strategy(name: str, *, aliases: Tuple[str, ...] = ()
                      ) -> Callable[[Type[PlanStrategy]],
                                    Type[PlanStrategy]]:
    """Class decorator: instantiate and register a strategy under ``name``
    (plus ``aliases``).  Re-registering a name replaces it — downstream
    code may override a built-in policy."""

    def deco(cls: Type[PlanStrategy]) -> Type[PlanStrategy]:
        inst = cls()
        inst.name = name
        _REGISTRY[name] = inst
        for alias in aliases:
            _ALIASES[alias] = name
        return cls

    return deco


def get_strategy(name: str) -> PlanStrategy:
    key = _ALIASES.get(name, name)
    try:
        return _REGISTRY[key]
    except KeyError:
        raise ValueError(f"unknown strategy {name!r}; pick from "
                         f"{available_strategies()}") from None


def available_strategies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# the paper's strategies (+ the beyond-paper ones)
# ---------------------------------------------------------------------------
@register_strategy("comp")
class CompStrategy(PlanStrategy):
    """SEGM_COMP: balance the layer-*count* proxy (vendor model)."""

    objective = "balance_params"

    def plan(self, ctx: PlanContext) -> PlacementPlan:
        cuts = comp_split(ctx.graph.params_per_depth(), ctx.n_stages())
        return self.finish(ctx, cuts)


@register_strategy("prof")
class ProfStrategy(PlanStrategy):
    """SEGM_PROF: exhaustive search over modeled pipeline batch time —
    C(d-1, s-1) candidates, shallow models only (the paper's point)."""

    objective = "min_pipeline_batch_time"

    def plan(self, ctx: PlanContext) -> PlacementPlan:
        model = ctx.model()
        cuts = prof_split(ctx.graph.params_per_depth(), ctx.n_stages(),
                          model.prof_cost(batch=ctx.spec.prof_batch))
        return self.finish(ctx, cuts, model=model)


@register_strategy("balanced")
class BalancedStrategy(PlanStrategy):
    """SEGM_BALANCED: Algorithm 1 params split + §6.1.3 refinement."""

    objective = "balance_params"
    default_refine = True

    def plan(self, ctx: PlanContext) -> PlacementPlan:
        cuts = balanced_split(ctx.graph.params_per_depth(), ctx.n_stages())
        return self.finish(ctx, cuts)


@register_strategy("balanced_norefine")
class BalancedNoRefineStrategy(BalancedStrategy):
    """SEGM_BALANCED step 2 only (Algorithm 1, no refinement)."""

    default_refine = False


@register_strategy("balanced_cost")
class BalancedCostStrategy(PlanStrategy):
    """Algorithm 1 over modeled per-depth *time* (MAC + weight-load
    terms — or the cost source's measured per-depth times) instead of raw
    params, then §6.1.3 refinement — fixes residual imbalance on archs
    whose MAC intensity varies with depth."""

    objective = "balance_modeled_time"
    default_refine = True

    def plan(self, ctx: PlanContext) -> PlacementPlan:
        model = ctx.model()
        # integer per-depth cost in nanoseconds (the engine keeps this
        # strategy's historical analytic expression bit-for-bit; a
        # trace-backed source substitutes its measured times)
        C = model.engine.depth_cost_ns()
        cuts = balanced_split(C, ctx.n_stages())
        return self.finish(ctx, cuts, model=model)


@register_strategy("opt")
class OptStrategy(PlanStrategy):
    """Time-balanced minimax DP over modeled stage time, with a hard
    guarantee: never worse than ``balanced`` on the max modeled stage time
    (falls back to the balanced cuts if the DP does not improve)."""

    objective = "min_max_stage_time"

    def plan(self, ctx: PlanContext) -> PlacementPlan:
        model = ctx.model()
        s = ctx.n_stages()
        cuts = minimax_time_split(ctx.graph.depth, s, model.segment_time)
        refinement = None
        base = get_strategy("balanced").plan(
            ctx.child("balanced", s, tpu_model=model))
        if max(model.stage_times(base.cuts)) < max(model.stage_times(cuts)):
            cuts = base.cuts
            refinement = base.refinement
        elif self.want_refine(ctx):      # explicit refine=True on DP cuts
            cuts, model, refinement = self.refine_pass(ctx, cuts, model)
        return self.finish(ctx, cuts, model=model, refinement=refinement)


@register_strategy("placement", aliases=("opt_placement",))
class PlacementStrategy(PlanStrategy):
    """Joint cuts + device-assignment + replica-count exact DP over a
    topology: a bottleneck stage pinned by a single dominant layer gets
    k-fold relief on its non-weight-load terms
    (``t_weight_load + (t - t_weight_load)/k`` pacing)."""

    objective = "min_max_stage_time"
    needs_topology = True

    def plan(self, ctx: PlanContext) -> PlacementPlan:
        topo = ctx.topology()
        n = topo.n_devices
        tcm = TopologyCostModel(ctx.graph, topo, ctx.device_base_spec(),
                                cost_source=ctx.cost_source())
        if topo.is_homogeneous and topo.devices[0].is_reference \
                and not ctx.spec.replicate:
            return get_strategy("opt").plan(
                ctx.child("opt", n, tpu_model=tcm.base_model))
        if ctx.spec.refine:
            # the joint cuts+replicas DP already fixes the replica
            # structure; a §6.1.3 cut-nudging pass cannot compose with it
            raise ValueError(
                "strategy 'placement' does not compose the refine "
                "post-pass; use strategy='balanced_placement' (per-stage "
                "device-limit refinement) or leave refine unset")
        rmax = n if ctx.spec.replicate else 1
        if ctx.spec.max_replicas is not None:
            rmax = min(rmax, max(1, ctx.spec.max_replicas))
        cuts, replicas = placement_split(ctx.graph.depth, n,
                                         tcm.placement_cost_fn(),
                                         max_replicas=rmax)
        offsets = [0]
        for r in replicas[:-1]:
            offsets.append(offsets[-1] + r)
        devices = [topo.devices[o] for o in offsets]
        return PlacementPlan.from_cuts(
            ctx.graph, cuts, strategy="opt_placement", devices=devices,
            replicas=replicas, tpu_model=tcm.base_model)


@register_strategy("balanced_placement")
class BalancedPlacementStrategy(PlanStrategy):
    """Algorithm 1 params split over a topology, refined with *per-stage*
    memory limits (each stage judged against its own device's capacity) —
    no replication search."""

    objective = "balance_params"
    default_refine = True
    needs_topology = True

    def plan(self, ctx: PlanContext) -> PlacementPlan:
        topo = ctx.topology()
        n = topo.n_devices
        tcm = TopologyCostModel(ctx.graph, topo, ctx.device_base_spec(),
                                cost_source=ctx.cost_source())
        if topo.is_homogeneous and topo.devices[0].is_reference \
                and not ctx.spec.replicate:
            return get_strategy("balanced").plan(
                ctx.child("balanced", n, tpu_model=tcm.base_model))
        cuts = balanced_split(ctx.graph.params_per_depth(), n)
        refinement = None
        if self.want_refine(ctx):
            reporters = tcm.stage_reporters(topo.devices[:n])
            refinement = refine_cuts(cuts, ctx.graph.depth,
                                     stage_reporters=reporters)
            if refinement.converged:
                cuts = refinement.cuts
        return PlacementPlan.from_cuts(
            ctx.graph, cuts, strategy="balanced_placement",
            devices=list(topo.devices[:len(cuts) + 1]),
            tpu_model=tcm.base_model, refinement=refinement)
