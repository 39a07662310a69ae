"""Raising-stub shim for the removed legacy planning entry points.

The plan types (:class:`~repro_torch.core.placement.StagePlacement`,
:class:`~repro_torch.core.placement.PlacementPlan`) and the stage-count rules
(``min_stages_to_fit`` / ``min_stages_no_spill``) live in
:mod:`repro_torch.core.placement`; import them from there (or from
``repro_torch.core``).  This module deliberately re-exports **nothing** — it
exists only so stale ``repro_torch.core.planner.plan(...)`` call sites fail
fast with the migration pointer instead of an ImportError three frames
deep.

The legacy orchestration entry points ``plan`` / ``plan_placement`` /
``plan_summary_table`` spent their one deprecation release as delegating
shims and were then removed; the repo's own surface migrated to
the ``repro_torch.api`` front door (DeploymentSpec -> plan -> Deployment), and
CI runs ``-W error::DeprecationWarning`` to keep it that way.
"""
from __future__ import annotations


def _removed(entry: str, replacement: str):
    """The legacy entry points had their one deprecation release (shims
    delegating to the registry, warning once per process); they are now
    stubs that fail fast with the migration pointer."""
    raise RuntimeError(
        f"repro_torch.core.planner.{entry} was removed after its deprecation "
        f"release; use {replacement} (see EXPERIMENTS.md §Deployment API)")


def plan(*_args, **_kwargs):
    """REMOVED — use ``repro_torch.api.plan``::

        from repro_torch.api import DeploymentSpec, plan
        plan(DeploymentSpec(stages=n, strategy="balanced"), graph=graph)
    """
    _removed("plan",
             "repro_torch.api.plan(DeploymentSpec(stages=..., strategy=...))")


def plan_placement(*_args, **_kwargs):
    """REMOVED — use ``repro_torch.api.plan``::

        from repro_torch.api import DeploymentSpec, plan
        plan(DeploymentSpec(topology=topo, strategy="placement"), graph=g)
    """
    _removed(
        "plan_placement",
        "repro_torch.api.plan(DeploymentSpec(topology=..., "
        "strategy='placement'))")


def plan_summary_table(*_args, **_kwargs):
    """REMOVED — call ``repro_torch.api.plan(DeploymentSpec(...))`` per
    strategy."""
    _removed("plan_summary_table",
             "repro_torch.api.plan(DeploymentSpec(...)) per strategy")


def __getattr__(name: str):
    if name in ("PlacementPlan", "SegmentationPlan", "StagePlacement",
                "min_stages_to_fit", "min_stages_no_spill"):
        raise AttributeError(
            f"repro_torch.core.planner.{name} moved to "
            f"repro_torch.core.placement; import it from repro_torch.core "
            f"or repro_torch.core.placement")
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
