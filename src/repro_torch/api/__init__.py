"""One front door: declarative DeploymentSpec -> Plan -> Deployment.

::

    from repro_torch.api import DeploymentSpec, plan, deploy

    pl = plan(DeploymentSpec(model="lm:qwen3-1.7b:seq=1024", stages=4,
                             strategy="balanced"))
    dep = deploy(spec, graph=g, stage_fn_builder=fns_for)

A copy of the reference package's front door, with the decode tier's
``decode_placement`` strategy registered.  Per-depth costs come from
``DeploymentSpec.cost_source``: ``"analytic"`` (the default),
``"trace:<path>"`` (measured per-depth times of a
:class:`~repro_torch.profiling.ProfileTrace`) or ``"calibrated:<path>"``
(the analytic model fitted to such a trace), as in the reference.  The
fleet tier's names (``Fleet``, ``FleetSpec``, ``deploy_fleet``, ...) are
re-exported lazily from :mod:`repro_torch.fleet`.
"""
from .spec import DeploymentSpec, resolve_model_graph
from .report import PlanReport
from .strategies import (PlanContext, PlanStrategy, available_strategies,
                         get_strategy, register_strategy)
from .deploy import Deployment, deploy, plan

# the decode tier's strategy lives in repro_torch.decode.placement, which
# imports this package's modules -- registration is deferred into a
# callable invoked once the registry exists
from ..decode.placement import _register as _register_decode
_register_decode()
del _register_decode

# fleet-tier names re-exported lazily (PEP 562): repro_torch.fleet imports
# from this package's submodules, so an eager import here would cycle
_FLEET_EXPORTS = ("Fleet", "FleetSpec", "FleetMemberSpec", "deploy_fleet",
                  "plan_fleet")

__all__ = [
    "DeploymentSpec", "resolve_model_graph",
    "PlanReport",
    "PlanContext", "PlanStrategy", "register_strategy", "get_strategy",
    "available_strategies",
    "plan", "deploy", "Deployment",
    *_FLEET_EXPORTS,
]


def __getattr__(name):
    if name in _FLEET_EXPORTS:
        from .. import fleet
        return getattr(fleet, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
