"""The one front door: ``plan(spec) -> PlacementPlan`` and
``deploy(spec) -> Deployment``.

The paper's pipeline is profile → segment → refine → place → execute.
Rather than ~10 loose functions whose orchestration every consumer would
hand-copy, this module is the single typed entry point:

* :func:`plan` — declarative :class:`~repro_torch.api.spec.DeploymentSpec` in,
  :class:`~repro_torch.core.placement.PlacementPlan` (with an attached
  :class:`~repro_torch.api.report.PlanReport`) out, dispatched through the
  strategy registry.
* :func:`deploy` / :class:`Deployment` — the runtime handle.  It owns
  executor/server construction so callers never wire
  ``PipelineExecutor``/``PipelinedModelServer`` by hand, and its
  :meth:`Deployment.reconfigure` drives the existing hot-swap path
  (drain in-flight, replan, swap) for elastic resizes.

::

    spec = DeploymentSpec(model="cnn:ResNet50", stages=4, strategy="opt")
    pl = plan(spec)                       # planning only
    print(pl.report.describe())

    dep = deploy(spec2, graph=g, stage_fn_builder=fns_for)
    with dep.serve() as server:           # admission loop + stage workers
        ...
        dep.reconfigure(spec2.with_stages(3))   # a device left
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

from ..core.edge_tpu_model import EdgeTPUModel, EdgeTPUSpec
from ..core.graph import LayerGraph
from ..core.pipeline import PipelineExecutor
from ..core.placement import PlacementPlan
from ..core.refine import MemoryReporter
from .report import PlanReport
from .spec import DeploymentSpec, resolve_model_graph
from .strategies import PlanContext, get_strategy

StageFnBuilder = Callable[[PlacementPlan], List[Callable[[Any], Any]]]


def plan(spec: DeploymentSpec, *,
         graph: Optional[LayerGraph] = None,
         tpu_model: Optional[EdgeTPUModel] = None,
         reporter: Optional[MemoryReporter] = None,
         base_spec: Optional[EdgeTPUSpec] = None,
         cost_source: Optional[Any] = None,
         attach_report: bool = True,
         cfg: Optional[Any] = None) -> PlacementPlan:
    """Turn a declarative spec into a placement plan.

    ``graph`` overrides ``spec.model`` resolution (pass a live LayerGraph
    you already built); ``tpu_model``/``reporter``/``base_spec`` override
    the default analytical device model, the refinement memory reporter,
    and the per-device constants — runtime objects that cannot live in the
    JSON spec.  ``cost_source`` overrides ``spec.cost_source`` resolution
    with a live :class:`~repro.profiling.sources.CostSource` instance —
    the self-healing loop replans against its in-memory live trace this
    way (there is no file to point a ``trace:<path>`` ref at).  ``cfg``
    is the LM config ``graph`` was built from: ``decode_placement`` prices
    its KV rows and widths (a full-width graph needs its full-width
    config; without one the strategy prices the spec's ``lm:`` ref's
    smoke config, as the reference does).  Every
    registered strategy is reachable; plans are bit-identical to the
    legacy ``repro_torch.core.planner`` entry points for the same inputs
    (asserted over all 21 Table-1 models in tests/test_deploy_api.py)."""
    if cfg is not None and graph is None:
        raise ValueError("cfg= prices the graph passed beside it; pass "
                         "graph= too")
    if graph is None:
        if spec.model is None:
            raise ValueError("spec has no model ref; pass plan(spec, "
                             "graph=...) or set DeploymentSpec.model")
        graph = resolve_model_graph(spec.model)
    strategy = get_strategy(spec.strategy)
    if spec.objective is not None and spec.objective != strategy.objective:
        raise ValueError(
            f"spec declares objective {spec.objective!r} but strategy "
            f"{spec.strategy!r} optimizes {strategy.objective!r}")
    if strategy.needs_topology and spec.resolved_topology() is None:
        raise ValueError(f"strategy {spec.strategy!r} plans over a device "
                         f"topology; set DeploymentSpec.topology or "
                         f"device_budget")
    ctx = PlanContext(spec=spec, graph=graph, tpu_model=tpu_model,
                      reporter=reporter, base_spec=base_spec, cfg=cfg,
                      _cost_source=cost_source,
                      _cost_source_resolved=cost_source is not None)
    pl = strategy.plan(ctx)
    if attach_report:
        # price the report with the model the planner itself used (the
        # tpu_model override included) so the report cannot contradict
        # the plan; ctx.model() reuses the context's cached instance.
        # Trace-backed cost sources also contribute the measured stage
        # times and the modeled-vs-trace error column.
        src_tag = (spec.cost_source if cost_source is None
                   else f"live:{getattr(cost_source, 'name', 'object')}")
        pl.report = PlanReport.from_plan(pl, base_model=ctx.model(),
                                         cost_source=src_tag,
                                         trace=ctx.trace(),
                                         decode=getattr(pl, "decode_info",
                                                        None))
    return pl


class Deployment:
    """A planned deployment and the runtime it owns.

    Construction is planning only — no threads, no jit.  Ask for the
    runtime explicitly:

    * :meth:`executor` — a :class:`PipelineExecutor` wired from the plan
      (replica fan-out) and the spec's serving policy (queue size,
      stage-level micro-batching).
    * :meth:`serve` — a :class:`PipelinedModelServer` over that executor
      (admission micro-batching, per-request futures, snapshot deltas).
    * :meth:`reconfigure` — replan for a new spec and hot-swap the live
      server (in-flight requests drain; queued requests are served by the
      new plan).

    Stage functions come from ``stage_fns`` (a fixed list) or
    ``stage_fn_builder`` (rebuilt per plan — required for
    :meth:`reconfigure`, which changes the stage count).
    """

    def __init__(self, spec: DeploymentSpec, plan: PlacementPlan, *,
                 graph: Optional[LayerGraph] = None,
                 stage_fn_builder: Optional[StageFnBuilder] = None,
                 stage_fns: Optional[Sequence[Callable]] = None,
                 tpu_model: Optional[EdgeTPUModel] = None,
                 reporter=None,
                 base_spec: Optional[EdgeTPUSpec] = None,
                 cfg: Optional[Any] = None):
        self.spec = spec
        self.plan = plan
        self.graph = graph
        self._builder = stage_fn_builder
        self._fns = list(stage_fns) if stage_fns is not None else None
        self._server = None
        self._closed = False
        # runtime pricing overrides deploy() planned with — re-passed on
        # every reconfigure() replan so resizes price against the same
        # device model as the original plan
        self._tpu_model = tpu_model
        self._reporter = reporter
        self._base_spec = base_spec
        self._cfg = cfg                 # the LM config behind ``graph``
        # resize baseline: ``reconfigure(stages=n)`` always derives from
        # this spec, not from the previous resize's output — a scale-down
        # that truncated the topology must not cap a later scale-up
        self._spec_template = spec

    @classmethod
    def from_plan(cls, plan: PlacementPlan,
                  spec: Optional[DeploymentSpec] = None, *,
                  graph: Optional[LayerGraph] = None,
                  stage_fn_builder: Optional[StageFnBuilder] = None,
                  stage_fns: Optional[Sequence[Callable]] = None,
                  tpu_model: Optional[EdgeTPUModel] = None,
                  reporter: Optional[MemoryReporter] = None,
                  base_spec: Optional[EdgeTPUSpec] = None
                  ) -> "Deployment":
        """Wrap an existing plan (shipped as JSON, hand-built, …) in a
        deployment handle.  The derived spec must keep :meth:`reconfigure`
        usable: the plan's strategy tag is adopted when it names a
        registered strategy (placement tags become a ``device_budget``
        spec sized to the plan's devices); hand-built tags (``manual``,
        ``replicated``, …) fall back to ``balanced`` resizes.  Pass
        ``spec=`` to control this explicitly, and
        ``tpu_model``/``reporter``/``base_spec`` if the plan was priced
        against non-default device constants so resizes are too."""
        if spec is None:
            try:
                strat = get_strategy(plan.strategy)
            except ValueError:
                strat = None
            if strat is None:
                spec = DeploymentSpec(stages=plan.n_stages,
                                      strategy="balanced")
            elif strat.needs_topology:
                spec = DeploymentSpec(strategy=strat.name,
                                      device_budget=plan.n_devices)
            else:
                spec = DeploymentSpec(stages=plan.n_stages,
                                      strategy=strat.name)
        return cls(spec, plan, graph=graph,
                   stage_fn_builder=stage_fn_builder, stage_fns=stage_fns,
                   tpu_model=tpu_model, reporter=reporter,
                   base_spec=base_spec)

    @property
    def server(self):
        """The live server, or None before :meth:`serve` / after it
        stopped (stopping through the server's own ``stop()``/``with``
        counts — the handle checks, it does not need to be told)."""
        return self._live_server()

    @property
    def closed(self) -> bool:
        """True once :meth:`close` ran.  ``close()`` is terminal: a
        closed deployment refuses to build runtime (:meth:`serve`,
        :meth:`executor`, :meth:`reconfigure`) — lifecycle owners that
        cycle servers (the fleet does, repeatedly) stop the *server*
        and call :meth:`serve` again instead."""
        return self._closed

    def _check_open(self, what: str) -> None:
        if self._closed:
            raise RuntimeError(
                f"deployment is closed; {what} needs a live deployment "
                f"(close() is terminal — build a new handle via "
                f"deploy() / Deployment.from_plan)")

    def _live_server(self):
        if self._server is not None and self._server.stopped:
            self._server = None            # stopped behind our back
        return self._server

    def stage_functions(self, plan: Optional[PlacementPlan] = None
                        ) -> List[Callable]:
        pl = plan if plan is not None else self.plan
        if self._builder is not None:
            return list(self._builder(pl))
        if self._fns is not None:
            if len(self._fns) != pl.n_stages:
                raise ValueError(
                    f"deployment carries {len(self._fns)} fixed stage fns "
                    f"but the plan has {pl.n_stages} stages; use "
                    f"stage_fn_builder for resizable deployments")
            return list(self._fns)
        raise ValueError("deployment has no stage functions; pass "
                         "stage_fns or stage_fn_builder to deploy()")

    def executor(self, start: bool = False, *,
                 backend: Optional[str] = None) -> PipelineExecutor:
        """A host :class:`PipelineExecutor` wired from the plan + spec
        (caller owns its lifecycle; use as a context manager or call
        stop()).  ``backend`` (default: the spec's) must be ``"host"``:
        the SPMD tier is not ported yet."""
        self._check_open("executor()")
        backend = backend if backend is not None else self.spec.backend
        if backend not in ("host", "spmd"):
            raise ValueError(f"unknown backend {backend!r}; pick 'host' "
                             f"or 'spmd'")
        if backend == "spmd":
            raise NotImplementedError(
                "backend='spmd': the SPMD pipeline tier "
                "(launch/pipeline_spmd.py) is not ported to repro_torch "
                "yet; it is the SPMD slice.  Use backend='host'")
        ex = PipelineExecutor.for_plan(
            self.plan, self.stage_functions(),
            queue_size=self.spec.queue_size,
            microbatch=self.spec.microbatch,
            microbatch_wait_s=self.spec.microbatch_wait_s,
            hedge_after=self.spec.hedge_after,
            name_prefix="deploy")
        if start:
            ex.start()
        return ex

    def serve(self, start: bool = False, *, params: Any = None):
        """The streaming server over this deployment's plan.  At most one
        live server per deployment (reconfigure targets it); a server the
        caller already stopped no longer counts.

        ``workload="decode"`` specs get a continuous-batching
        :class:`~repro_torch.decode.engine.DecodeServer` (token streams,
        not request/response futures) for the config the plan priced;
        ``params`` supplies its weights on the device to serve on (fresh
        smoke weights on the card otherwise, for the spec's smoke config
        only)."""
        self._check_open("serve()")
        if self.spec.workload == "decode":
            from ..decode.engine import build_decode_server
            srv = build_decode_server(
                self.spec, plan=self.plan, params=params, cfg=self._cfg,
                queue_size=self.spec.queue_size)
            if start:
                srv.start()
            return srv
        if self._live_server() is not None:
            raise RuntimeError("deployment already has a live server; "
                               "stop it before serving again")
        from ..serving.server import PipelinedModelServer
        srv = PipelinedModelServer(
            self.plan, self.stage_functions(),
            max_batch=self.spec.max_batch, max_wait_s=self.spec.max_wait_s,
            queue_size=self.spec.queue_size,
            microbatch=self.spec.microbatch,
            microbatch_wait_s=self.spec.microbatch_wait_s,
            hedge_after=self.spec.hedge_after,
            stage_loss_retries=self.spec.stage_loss_retries,
            deadline_s=(None if self.spec.deadline_ms is None
                        else self.spec.deadline_ms / 1e3),
            shed_policy=self.spec.shed_policy)
        self._server = srv
        if start:
            srv.executor.start()
            srv.start()
        return srv

    def self_heal(self, canary_payloads: Sequence[Any], *,
                  policy=None, poll_interval_s: float = 0.25):
        """A :class:`~repro_torch.runtime.selfheal.SelfHealingController`
        wired to this deployment's live server: live telemetry -> rolling
        trace -> drift detection -> guarded (canary + rollback) replans
        through the front-door registry.  Needs a live :meth:`serve`
        server and a ``stage_fn_builder`` (replans change the stage
        shapes).  The spec's ``drift_threshold``/``canary_requests`` seed
        the policy unless an explicit ``policy`` is given.  Caller owns
        the controller's lifecycle (use as a context manager)."""
        self._check_open("self_heal()")
        srv = self._live_server()
        if srv is None:
            raise RuntimeError("self_heal needs a live server; call "
                               "serve() first")
        if self._builder is None:
            raise ValueError("self_heal needs stage_fn_builder (guarded "
                             "replans rebuild the stage functions)")
        from ..runtime.selfheal import DriftPolicy, SelfHealingController
        if policy is None:
            policy = DriftPolicy(
                drift_threshold=self.spec.drift_threshold or 0.5,
                canary_requests=self.spec.canary_requests)
        return SelfHealingController(
            srv, self.spec, self.graph, self._builder,
            policy=policy, canary_payloads=canary_payloads,
            poll_interval_s=poll_interval_s,
            tpu_model=self._tpu_model, base_spec=self._base_spec)

    def reconfigure(self, spec: Optional[DeploymentSpec] = None, *,
                    stages: Optional[int] = None,
                    drain_timeout: float = 30.0) -> PlacementPlan:
        """Replan under a new spec (or the same deployment at a new device
        count via ``stages=``) and hot-swap the live server through the
        existing drain-and-swap path.  Without a live server this just
        re-plans and updates the handle."""
        self._check_open("reconfigure()")
        if (spec is None) == (stages is None):
            raise ValueError("pass exactly one of spec or stages")
        if spec is not None:
            new_spec = self._spec_template = spec
        else:
            new_spec = self._spec_template.with_stages(stages)
        new_plan = plan(new_spec, graph=self.graph,
                        tpu_model=self._tpu_model, reporter=self._reporter,
                        base_spec=self._base_spec, cfg=self._cfg)
        fns = self.stage_functions(new_plan)
        if self._live_server() is not None:
            self._server.reconfigure(new_plan, fns,
                                     drain_timeout=drain_timeout)
        self.spec = new_spec
        self.plan = new_plan
        return new_plan

    def close(self) -> None:
        """Stop any live server and retire the handle.  Terminal and
        idempotent: a second ``close()`` is a no-op, but ``serve()`` /
        ``executor()`` / ``reconfigure()`` after it raise — a consumer
        holding a closed handle is a lifecycle bug, not a state to limp
        through."""
        self._closed = True
        if self._server is not None:
            self._server.stop()
            self._server = None

    def __enter__(self) -> "Deployment":
        self._check_open("entering the context")
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def deploy(spec: DeploymentSpec, *,
           graph: Optional[LayerGraph] = None,
           stage_fn_builder: Optional[StageFnBuilder] = None,
           stage_fns: Optional[Sequence[Callable]] = None,
           tpu_model: Optional[EdgeTPUModel] = None,
           reporter: Optional[MemoryReporter] = None,
           base_spec: Optional[EdgeTPUSpec] = None,
           cfg: Optional[Any] = None) -> Deployment:
    """Plan a spec and wrap it in a :class:`Deployment` handle (``cfg``:
    the LM config behind ``graph``, see :func:`plan`)."""
    if cfg is not None and graph is None:
        raise ValueError("cfg= prices the graph passed beside it; pass "
                         "graph= too")
    if graph is None and spec.model is not None:
        graph = resolve_model_graph(spec.model)
    pl = plan(spec, graph=graph, tpu_model=tpu_model, reporter=reporter,
              base_spec=base_spec, cfg=cfg)
    return Deployment(spec, pl, graph=graph,
                      stage_fn_builder=stage_fn_builder,
                      stage_fns=stage_fns, tpu_model=tpu_model,
                      reporter=reporter, base_spec=base_spec, cfg=cfg)
