"""The port's fleet tier (``repro_torch.fleet``, ``serve --fleet``) against
the reference's (``repro.fleet``).

The fleet document format (``repro.fleet_spec/v1``: ``examples/fleet.json``
reads and writes the same JSON in both packages), the pool-split solver's
counts, mode and worst norm, the router's deficit-round-robin dispatch
order over stub servers, the autoscaler's events under the same ticks and
injected observations, a scenario drive audited clean, and the CLI's
``--fleet`` path on the CPU.  Stage functions are identity or sleep-based
host functions, as in the reference's scenario; decisions are exact.
"""
import json
import pathlib
import time

import pytest

torch = pytest.importorskip("torch")

from repro import api as japi
from repro import fleet as jfleet
from repro.fleet.router import FleetRouter as JRouter
from repro.serving.server import Request as JRequest
from repro_torch import api as tapi
from repro_torch import fleet as tfleet
from repro_torch.fleet.router import FleetRouter
from repro_torch.fleet.scenario import FleetScenario, TrafficPhase
from repro_torch.launch import serve as tserve
from repro_torch.serving.server import Request

EXAMPLE = pathlib.Path(__file__).resolve().parents[1] / "examples" \
    / "fleet.json"
PKGS = {"port": (tapi, tfleet, FleetRouter, Request),
        "ref": (japi, jfleet, JRouter, JRequest)}


def _spec(pkg, members, **fleet_kw):
    """A FleetSpec of ``members``: (name, model ref, share, spec fields)."""
    api, fl, _, _ = PKGS[pkg]
    return fl.FleetSpec(members=tuple(
        fl.FleetMemberSpec(name=n, spec=api.DeploymentSpec(model=m, **kw),
                           share=share)
        for n, m, share, kw in members), **fleet_kw)


SKEWED = [("heavy", "synthetic-cnn:12", 2.0,
           dict(slo_p95_ms=40.0, slo_throughput_rps=9000.0)),
          ("mid", "synthetic-cnn:8", 1.0,
           dict(slo_p95_ms=25.0, slo_throughput_rps=2500.0)),
          ("light", "synthetic-cnn:8", 1.0,
           dict(slo_p95_ms=25.0, slo_throughput_rps=1200.0))]


def _identity_builders(spec):
    def builder(pl):
        return [(lambda x: x) for _ in pl.stage_depth_ranges]
    return {n: builder for n in spec.member_names}


def test_example_fleet_json_round_trips_to_the_same_json():
    text = EXAMPLE.read_text()
    port = tfleet.FleetSpec.from_json(text)
    ref = jfleet.FleetSpec.from_json(text)
    assert port.to_json(indent=1) == ref.to_json(indent=1)
    # the file predates the decode fields of DeploymentSpec: both
    # packages write them with their defaults, and everything else as the
    # file has it
    doc, want = json.loads(port.to_json()), json.loads(text)
    defaults = tapi.DeploymentSpec().to_dict()
    for m, w in zip(doc["members"], want["members"]):
        for key in set(m["spec"]) - set(w["spec"]):
            assert m["spec"].pop(key) == defaults[key]
    assert doc == want
    assert tfleet.FleetSpec.from_json(port.to_json()) == port
    assert port.member_names == ("vision", "detect", "embed")
    assert port.pool().n_devices == 9


def _plan_row(pkg, spec_doc, fixed=None):
    _, fl, _, _ = PKGS[pkg]
    p = fl.plan_fleet(fl.FleetSpec.from_json(spec_doc), fixed_counts=fixed)
    return (p.mode, p.device_counts(), p.worst_norm,
            [(a.name, a.n_devices, list(a.plan.cuts),
              list(a.plan.replica_counts), a.time_share)
             for a in p.allocations])


@pytest.mark.parametrize("case", ["example", "pool1", "pool3", "pool6",
                                  "pool9", "fixed"])
def test_plan_fleet_matches_reference(case):
    if case == "example":
        doc, fixed = EXAMPLE.read_text(), None
    else:
        pool = 6 if case == "fixed" else int(case[4:])
        doc = _spec("port", SKEWED, device_budget=pool).to_json()
        fixed = ({"heavy": 2, "mid": 2, "light": 2} if case == "fixed"
                 else None)
    got = _plan_row("port", doc, fixed)
    assert got == _plan_row("ref", doc, fixed)
    assert got[0] == ("time_sliced" if case == "pool1" else "partitioned")


class _StubServer:
    """Completes every dispatch synchronously and logs it."""

    def __init__(self, log, name, request_cls):
        self.log, self.name, self.request_cls = log, name, request_cls
        self.stopped = False

    def submit(self, payload, deadline_s=None):
        req = self.request_cls(rid=len(self.log), payload=payload)
        req.result = payload
        req.t_done = time.perf_counter()
        req.event.set()
        self.log.append((self.name, payload))
        return req


def _drr_order(pkg, shares, per_member):
    """The dispatch order of a backlog queued before the router starts."""
    _, _, router_cls, request_cls = PKGS[pkg]
    log = []
    servers = {n: _StubServer(log, n, request_cls) for n in shares}
    router = router_cls(servers={n: (lambda s=s: s)
                                 for n, s in servers.items()},
                        shares=shares)
    reqs = [router.submit(n, (n, i)) for n in shares
            for i in range(per_member[n])]
    with router:
        assert all(r.event.wait(30) for r in reqs)
    return log, router.snapshot()["members"]


@pytest.mark.parametrize("shares,per_member", [
    ({"a": 2.0, "b": 1.0}, {"a": 12, "b": 6}),
    ({"a": 3.0, "b": 1.0, "c": 2.0}, {"a": 9, "b": 5, "c": 7}),
    ({"a": 1.0, "b": 1.0}, {"a": 3, "b": 8}),
], ids=["two_to_one", "three_members", "uneven_backlog"])
def test_router_drr_order_matches_reference(shares, per_member):
    got, snap = _drr_order("port", shares, per_member)
    want, jsnap = _drr_order("ref", shares, per_member)
    assert got == want
    assert {n: m["completed"] for n, m in snap.items()} == per_member
    assert snap == jsnap
    for n in shares:                        # per-member FIFO
        assert [p for m, p in got if m == n] == \
            [(n, i) for i in range(per_member[n])]


def _autoscale_events(pkg, script):
    """A two-member fleet over 4 devices with identity stages; before
    each tick, inject the observed-norm EWMA of ``script``'s step (the
    members see no traffic, so nothing else moves it)."""
    _, fl, _, _ = PKGS[pkg]
    spec = _spec(pkg, [("a", "synthetic-cnn:8", 1.0, dict(slo_p95_ms=20.0)),
                       ("b", "synthetic-cnn:8", 1.0,
                        dict(slo_p95_ms=20.0))], device_budget=4)
    fleet = fl.deploy_fleet(spec, stage_fn_builders=_identity_builders(spec))
    rows = []
    with fleet:
        auto = fleet.autoscaler
        for inject in script:
            auto._norm_ewma.update(inject)
            ev = auto.tick()
            rows.append((ev["event"], ev.get("move"),
                         dict(auto.device_counts),
                         {n: d.plan.n_devices
                          for n, d in fleet.deployments.items()}))
    return rows


@pytest.mark.parametrize("script", [
    [{}, {"a": 5.0}, {}, {}, {}, {}, {}],
    [{"a": 5.0}, {}, {"a": 6.0, "b": 0.5}, {}, {}, {"b": 4.0}, {}],
], ids=["move_guard_commit", "rollback_then_move_back"])
def test_autoscaler_events_match_reference(script):
    got = _autoscale_events("port", script)
    assert got == _autoscale_events("ref", script)
    assert {"move", "guard"} <= {row[0] for row in got}


def test_scenario_drive_audits_clean():
    spec = _spec("port", [("a", "synthetic-cnn:8", 2.0,
                           dict(slo_p95_ms=50.0)),
                          ("b", "synthetic-cnn:8", 1.0,
                           dict(slo_p95_ms=50.0))], device_budget=4)
    sc = FleetScenario(spec, {"a": 1e-4, "b": 1e-4})
    with sc.deploy() as fleet:
        metrics = sc.drive(fleet, [
            TrafficPhase(windows=2, rates={"a": 4, "b": 2}),
            TrafficPhase(windows=2, rates={"a": 12, "b": 2})])
    audit = sc.audit()
    for name, n in (("a", 32), ("b", 8)):
        assert audit[name] == {"submitted": n, "exited": n, "lost": 0,
                               "misordered": 0}
        assert metrics[name]["submitted"] == n
    assert FleetScenario.worst(sc.attainment(metrics)) <= 1.0


def test_serve_fleet_entry_point_on_cpu():
    res = tserve.main(["--fleet", str(EXAMPLE), "--fleet-windows", "2",
                       "--fleet-service-ms", "1"])
    assert set(res["audit"]) == {"vision", "detect", "embed"}
    # a request past the file's 500 ms deadline fails; none may hang
    for a in res["audit"].values():
        assert a["lost"] == 0 and a["misordered"] == 0
        assert 0 < a["exited"] <= a["submitted"]
    assert sum(res["counts_before"].values()) == 9
    assert sum(res["counts_after"].values()) == 9
