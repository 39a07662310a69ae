"""Shared test helpers.

``api_plan`` is the :mod:`repro.api` front door exposed with the legacy
positional call shape most tests were written against — every test plans
through the strategy registry (no DeprecationWarnings anywhere in the
suite; CI runs a ``-W error::DeprecationWarning`` leg to prove it).  The
removed ``repro.core.planner`` entry points are exercised only by the
raises-with-pointer tests in tests/test_deploy_api.py.
"""
from repro.api import DeploymentSpec
from repro.api import plan as _front_door_plan


def api_plan(graph, n_stages, strategy="balanced", reporter=None,
             tpu_model=None, **spec_kw):
    """plan(graph, n, strategy, ...) in the legacy shape, via repro.api."""
    return _front_door_plan(
        DeploymentSpec(stages=n_stages, strategy=strategy, **spec_kw),
        graph=graph, tpu_model=tpu_model, reporter=reporter)


def api_plan_placement(graph, topology, strategy="opt", replicate=True,
                       max_replicas=None, base_spec=None):
    """plan_placement(...) in the legacy shape, via repro.api."""
    name = "placement" if strategy == "opt" else "balanced_placement"
    return _front_door_plan(
        DeploymentSpec(strategy=name, topology=topology,
                       replicate=replicate, max_replicas=max_replicas),
        graph=graph, base_spec=base_spec)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU of compute capability >= 9.0 "
        "(the port's hand-written kernels); skips elsewhere")
