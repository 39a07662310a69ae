"""One front door: declarative DeploymentSpec -> Plan -> Deployment.

::

    from repro_torch.api import DeploymentSpec, plan, deploy

    pl = plan(DeploymentSpec(model="lm:qwen3-1.7b:seq=1024", stages=4,
                             strategy="balanced"))
    dep = deploy(spec, graph=g, stage_fn_builder=fns_for)

A copy of the reference package's front door.  Per-depth costs are
``"analytic"`` only; the trace-backed cost sources, the decode tier and the
fleet tier are not ported yet.
"""
from .spec import DeploymentSpec, resolve_model_graph
from .report import PlanReport
from .strategies import (PlanContext, PlanStrategy, available_strategies,
                         get_strategy, register_strategy)
from .deploy import Deployment, deploy, plan

__all__ = [
    "DeploymentSpec", "resolve_model_graph",
    "PlanReport",
    "PlanContext", "PlanStrategy", "register_strategy", "get_strategy",
    "available_strategies",
    "plan", "deploy", "Deployment",
]
