"""The port's self-healing loop (``repro_torch.runtime.selfheal``,
``repro_torch.profiling.live``, ``Deployment.self_heal``) against the
reference's.

The same seeded observation series (numpy) through both packages' drift
detectors and live trace builders; the controller's commit, rollback,
backoff, degrade and re-arm sequence under ``tick()`` against a scripted
fake server (no controller thread, no sleeps); and ``Deployment.
self_heal`` wired over ``cnn_stage_fns`` on a synthetic CNN on the CPU.
Drift values and decisions are exact; live traces within 1e-12.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi
from repro.core.edge_tpu_model import EdgeTPUSpec as JEdge
from repro.core.placement import PlacementPlan as JPlan
from repro.models import cnn as jcnn
from repro.profiling import LiveTraceBuilder as JLive
from repro.runtime import DriftDetector as JDetector
from repro.runtime import DriftPolicy as JPolicy
from repro.runtime import SelfHealingController as JController
from repro_torch import api as tapi
from repro_torch.core.edge_tpu_model import EdgeTPUSpec
from repro_torch.core.placement import PlacementPlan
from repro_torch.launch import serve as tserve
from repro_torch.models import cnn as tcnn
from repro_torch.profiling import LiveTraceBuilder
from repro_torch.runtime import (DriftDetector, DriftPolicy,
                                 SelfHealingController)

PKGS = {
    "port": dict(api=tapi, cnn=tcnn, plan_cls=PlacementPlan,
                 live=LiveTraceBuilder, det=DriftDetector, pol=DriftPolicy,
                 ctl=SelfHealingController, edge=EdgeTPUSpec,
                 deploy=importlib.import_module("repro_torch.api.deploy")),
    "ref": dict(api=japi, cnn=jcnn, plan_cls=JPlan, live=JLive,
                det=JDetector, pol=JPolicy, ctl=JController, edge=JEdge,
                deploy=importlib.import_module("repro.api.deploy")),
}
MODELS = {"synthetic_cnn(600, L=8)": lambda c: c.synthetic_cnn(600, L=8),
          "ResNet50": lambda c: c.REAL_CNNS["ResNet50"]()}


def _series(seed, n, stages):
    """``n`` windows of per-stage observed times: seeded noise, a skew on
    stage 0 from window n // 3 on, calm again from 2n // 3."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.005, 0.02, stages)
    out = []
    for w in range(n):
        obs = base * (1 + 0.1 * rng.random(stages))
        if n // 3 <= w < 2 * n // 3:
            obs[0] *= 4.0
        out.append([float(x) for x in obs])
    return [float(x) for x in base], out


def _drift_run(pkg, seed, policy):
    k = PKGS[pkg]
    modeled, series = _series(seed, 30, 4)
    det = k["det"](k["pol"](**policy))
    rows = []
    for w, obs in enumerate(series):
        if w == 20:
            det.rebase()                    # a replan landed
        rows.append((det.observe(modeled, obs), det.triggered))
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("policy", [
    dict(drift_threshold=0.4, hysteresis=3),
    dict(drift_threshold=0.2, hysteresis=1, ewma_alpha=1.0),
], ids=["smoothed", "raw"])
def test_drift_detector_trigger_sequence_matches_reference(seed, policy):
    got = _drift_run("port", seed, policy)
    assert got == _drift_run("ref", seed, policy)
    assert any(t for _, t in got) and not all(t for _, t in got)


def _live_run(pkg, model, seed):
    k = PKGS[pkg]
    g = MODELS[model](k["cnn"]).to_layer_graph()
    pl = k["api"].plan(k["api"].DeploymentSpec(stages=4), graph=g)
    ranges = [tuple(r) for r in pl.stage_depth_ranges]
    rng = np.random.default_rng(seed)
    ltb = k["live"](g, alpha=0.25)
    for w in range(6):
        per_item = [float(x) for x in rng.uniform(0.001, 0.01, len(ranges))]
        items = [int(x) for x in rng.integers(0, 3, len(ranges))]
        ltb.observe(ranges, per_item, items)
    tr = ltb.trace()
    cal = ltb.cost_source("calibrated")
    edge = k["edge"]()
    return (ltb.coverage(), ltb.windows, tr.graph_name, tr.device,
            tr.repeats, [(s.depth, s.time_s, s.layers, s.params, s.macs,
                          s.weight_bytes, s.act_bytes, s.low_intensity_macs)
                         for s in tr.samples],
            [cal.layer_time_s(d, g, edge) for d in range(g.depth)])


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_live_trace_matches_reference(model, seed):
    got = _live_run("port", model, seed)
    want = _live_run("ref", model, seed)
    assert got[:5] == want[:5]
    assert [s[0] for s in got[5]] == [s[0] for s in want[5]]
    for a, b in zip(got[5], want[5]):
        assert abs(a[1] - b[1]) <= 1e-12
        assert tuple(a[2]) == tuple(b[2]) and a[3:] == b[3:]
    np.testing.assert_allclose(got[6], want[6], rtol=0, atol=1e-12)


class _FakeServer:
    """Interface double for PipelinedModelServer: scripted snapshots,
    recorded reconfigures."""

    def __init__(self, pl):
        self.plan = pl
        self.stage_fns = [lambda x: x] * pl.n_stages
        self.snaps = []
        self.reconfigures = []

    def snapshot(self):
        return self.snaps.pop(0)

    def reconfigure(self, pl, fns, drain_timeout=30.0):
        self.reconfigures.append(list(pl.cuts))
        self.plan = pl
        self.stage_fns = list(fns)


def _snap(pl, skew):
    """The plan's modeled stage times, stage 0 times ``skew``."""
    t = [float(x) for x in pl.stage_times_s]
    t[0] *= skew
    return {"stage_time_per_req_s": t, "stage_items": [10] * pl.n_stages}


def _controller_run(pkg, monkeypatch):
    """Skewed windows: the first replan commits candidate A (its canary
    runs identity stages, far below the 8x-skewed incumbent); later
    replans return candidate B, whose canary stages raise: rollback,
    seeded backoff, retries, degraded; calm windows re-arm.  Returns the
    per-tick (state, backoff, retries, commits, rollbacks, replans), the
    event kinds and the reconfigures."""
    k = PKGS[pkg]
    g = MODELS["synthetic_cnn(600, L=8)"](k["cnn"]).to_layer_graph()
    incumbent = k["api"].plan(k["api"].DeploymentSpec(stages=3), graph=g)
    a = k["plan_cls"].from_cuts(g, [1, 3])
    b = k["plan_cls"].from_cuts(g, [2, 5])
    replans = iter([a] + [b] * 10)
    monkeypatch.setattr(k["deploy"], "plan", lambda *x, **kw: next(replans))

    def builder(pl):
        if list(pl.cuts) == list(b.cuts):
            def boom(x):
                raise RuntimeError("candidate replica crashed")
            return [boom] * pl.n_stages
        return [lambda x: x] * pl.n_stages

    pol = k["pol"](drift_threshold=0.3, hysteresis=1, cooldown_windows=1,
                   ewma_alpha=1.0, max_canary_retries=2,
                   backoff_base_windows=1, backoff_max_windows=4,
                   backoff_seed=0)
    srv = _FakeServer(incumbent)
    ctl = k["ctl"](srv, k["api"].DeploymentSpec(stages=3), g, builder,
                   policy=pol, canary_payloads=[1, 2])
    rows = []
    for w in range(16):
        srv.snaps.append(_snap(srv.plan, 8.0 if w < 13 else 1.0))
        ctl.tick()
        rows.append((ctl.state, ctl._backoff, ctl._retries, ctl.commits,
                     ctl.rollbacks, ctl.replans, ctl.windows))
    return rows, [(e["window"], e["kind"], e["state"]) for e in ctl.events], \
        srv.reconfigures


def test_controller_sequence_matches_reference(monkeypatch):
    got = _controller_run("port", monkeypatch)
    want = _controller_run("ref", monkeypatch)
    assert got == want
    kinds = {kind for _, kind, _ in got[1]}
    assert {"commit", "rollback", "degraded", "rearmed"} <= kinds
    assert got[2] == [[1, 3]]               # A committed, B never
    assert "backoff" in {row[0] for row in got[0]}


def test_controller_noop_when_the_live_plan_is_the_incumbent(monkeypatch):
    g = tcnn.synthetic_cnn(600, L=8).to_layer_graph()
    incumbent = tapi.plan(tapi.DeploymentSpec(stages=3), graph=g)
    monkeypatch.setattr(PKGS["port"]["deploy"], "plan",
                        lambda *a, **k: incumbent)
    srv = _FakeServer(incumbent)
    srv.snaps.append(_snap(incumbent, 8.0))
    ctl = SelfHealingController(
        srv, tapi.DeploymentSpec(stages=3), g,
        lambda pl: [lambda x: x] * pl.n_stages,
        policy=DriftPolicy(drift_threshold=0.3, hysteresis=1,
                           cooldown_windows=2, ewma_alpha=1.0),
        canary_payloads=[1])
    ctl.tick()
    assert srv.reconfigures == [] and ctl.state == "cooldown"
    assert [e["kind"] for e in ctl.events] == ["noop"]


def test_deployment_self_heal_over_cnn_stage_fns():
    """``Deployment.self_heal`` wires the live server, the deployment's
    graph and its ``cnn_stage_fns`` builder; one tick folds the served
    window into the live trace, and a real replan's canary runs the
    rebuilt stages on the CPU."""
    m = tcnn.synthetic_cnn(16, L=6, hw=16)
    params = m.init("cpu", torch.Generator().manual_seed(0))
    dep = tserve.deploy_cnn(m, params, tapi.DeploymentSpec(
        model="synthetic-cnn:16", stages=3, drift_threshold=0.3,
        canary_requests=2), "cpu")
    reqs = tserve.cnn_requests(m, 6, "cpu", seed=1)
    with dep.serve() as server:
        server.start()
        healer = dep.self_heal(reqs[:2])
        assert healer.server is server and healer.graph is dep.graph
        assert healer.policy.drift_threshold == 0.3
        assert healer.policy.canary_requests == 2
        server.snapshot()
        pending = [server.submit(r) for r in reqs]
        assert all(r.event.wait(60) for r in pending)
        healer.tick()
        assert healer.windows == 1 and healer.trace.coverage() == 1.0
        ok, _, canary, err = healer._canary_validate(dep.plan)
        assert err is None and canary is not None
    for r, x in zip(pending, reqs):
        assert torch.equal(r.result[m.output], m.apply(params, x[m.INPUT]))
    with pytest.raises(RuntimeError, match="live server"):
        dep.self_heal(reqs[:2])
