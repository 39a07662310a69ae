"""The port's fault-tolerance runtime (``repro_torch.runtime``: ft, chaos,
straggler) against the reference's (``repro.runtime``).

Same graphs, same seeds, same inputs through both packages: the elastic
planner's cuts, the seeded kill schedules and failure-injector decisions,
the chaos harness's exactly-once audit under replica deaths, the
supervisor's restart from a checkpoint, the speculative executor's first
success, and the health monitor's probe and degraded-mode replan driven
directly (no monitor thread, no sleeps: replica deaths come from call
counts, never from the clock).  Stage functions are plain Python on the
CPU; plans and decisions are exact.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi
from repro import runtime as jrt
from repro.checkpoint import CheckpointStore as JStore
from repro.core.pipeline import PipelineExecutor as JExecutor
from repro.core.pipeline import ReplicaFailure as JReplicaFailure
from repro.models import cnn as jcnn
from repro.serving import PipelinedModelServer as JServer
from repro_torch import api as tapi
from repro_torch import runtime as trt
from repro_torch.checkpoint import CheckpointStore
from repro_torch.core.pipeline import PipelineExecutor, ReplicaFailure
from repro_torch.models import cnn as tcnn
from repro_torch.serving import PipelinedModelServer

PKGS = {"port": (tapi, trt, PipelineExecutor, ReplicaFailure,
                 PipelinedModelServer),
        "ref": (japi, jrt, JExecutor, JReplicaFailure, JServer)}
GRAPHS = {"synthetic_cnn(600, L=8)": (lambda: tcnn.synthetic_cnn(600, L=8),
                                      lambda: jcnn.synthetic_cnn(600, L=8)),
          "ResNet50": (lambda: tcnn.REAL_CNNS["ResNet50"](),
                       lambda: jcnn.REAL_CNNS["ResNet50"]())}


def _plan_row(pl):
    return (list(pl.cuts), list(pl.replica_counts), pl.n_devices,
            [round(float(t), 12) for t in pl.stage_times_s])


@pytest.mark.parametrize("n", range(1, 7))
@pytest.mark.parametrize("model", sorted(GRAPHS))
def test_elastic_planner_cuts_match_reference(model, n):
    tmake, jmake = GRAPHS[model]
    got = trt.ElasticPlanner(tmake().to_layer_graph()).plan_for(n)
    want = jrt.ElasticPlanner(jmake().to_layer_graph()).plan_for(n)
    assert _plan_row(got) == _plan_row(want)


@pytest.mark.parametrize("n", [2, 4, 6])
def test_elastic_placement_planner_matches_reference(n):
    """A placement spec resizes its device budget, as the chaos phase's
    replans do."""
    tspec = tapi.DeploymentSpec(strategy="placement", device_budget=6)
    jspec = japi.DeploymentSpec(strategy="placement", device_budget=6)
    got = trt.ElasticPlanner(tcnn.synthetic_cnn(600).to_layer_graph(),
                             spec=tspec).on_resize(n)
    want = jrt.ElasticPlanner(jcnn.synthetic_cnn(600).to_layer_graph(),
                              spec=jspec).on_resize(n)
    assert _plan_row(got) == _plan_row(want)


@pytest.mark.parametrize("args", [
    ([2, 3, 3], 4, 1.0, dict(seed=11)),
    ([2, 3, 3], 9, 1.0, dict(seed=11, max_per_stage=1)),
    ([2], 2, 1.0, dict(seed=0, spare_last=False)),
    ([1, 4, 2, 3], 5, 2.5, dict(seed=7)),
    ([3, 3], 6, 0.5, dict(seed=3, spare_last=False, max_per_stage=2)),
], ids=["spare_last", "max_per_stage", "stage_loss", "four_stages",
        "capped_loss"])
def test_kill_schedule_matches_reference(args):
    reps, n, dur, kw = args
    got = trt.replica_kill_schedule(reps, n, dur, **kw)
    want = jrt.replica_kill_schedule(reps, n, dur, **kw)
    assert [(e.at_s, e.kind, e.stage, e.slot) for e in got] == \
        [(e.at_s, e.kind, e.stage, e.slot) for e in want]


def _decisions(pkg, seed):
    rt = PKGS[pkg][1]
    inj = rt.FailureInjector(fail_at_steps=[1, 4, 9], fail_rate=0.3,
                             seed=seed)
    out = []
    for step in range(12):
        for target in (None, "s0", "s1"):
            for _ in range(2):              # each decision fires once
                try:
                    inj.check(step, target=target)
                    out.append(None)
                except RuntimeError as e:
                    out.append(str(e))
    return out


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_failure_injector_decisions_match_reference(seed):
    assert _decisions("port", seed) == _decisions("ref", seed)


def test_failure_injector_wrap_counts_calls_per_target():
    inj = trt.FailureInjector(fail_at_steps=[1], exc_type=ReplicaFailure)
    fa = inj.wrap(lambda x: x * 2, "a")
    fb = inj.wrap(lambda x: x * 3, "b")
    assert fa(1) == 2 and fb(1) == 3
    with pytest.raises(ReplicaFailure):
        fa(1)
    with pytest.raises(ReplicaFailure):
        fb(1)
    assert fa(4) == 8 and fb(4) == 12


def _chaos(pkg, n_requests=60):
    """Each replicated stage loses one replica at its 5th and 12th calls
    (the injector's call counts, not the clock): exactly-once audit."""
    _, rt, _, rf, _ = PKGS[pkg]
    inj = rt.FailureInjector(fail_at_steps=[5, 12], exc_type=rf)
    fns = [inj.wrap(lambda x: x, "s0"), inj.wrap(lambda x: x, "s1")]
    rep = rt.run_chaos_executor(fns, [3, 3], n_requests=n_requests,
                                timeout_s=60)
    return (rep.submitted, rep.completed, rep.failed, rep.lost,
            rep.misordered, rep.health["live_replicas"])


def test_chaos_executor_exactly_once_under_replica_deaths():
    got = _chaos("port")
    assert got == (60, 60, 0, 0, 0, [1, 1, 1])
    assert got == _chaos("ref")


def test_chaos_executor_stage_loss_fails_never_loses():
    """Every replica of a stage dies (at its calls 3 and 4): later
    requests fail as StageLost, none hangs, none exits out of order."""
    inj = trt.FailureInjector(fail_at_steps=[3, 4], exc_type=ReplicaFailure)
    rep = trt.run_chaos_executor([inj.wrap(lambda x: x, "s0")], [2],
                                 n_requests=20, timeout_s=60)
    assert rep.lost == 0 and rep.misordered == 0
    assert rep.completed + rep.failed == 20 and rep.failed > 0
    assert rep.health["live_replicas"] == [0, 1]


def test_chaos_monkey_applies_immediate_events_to_the_live_executor():
    """Events due at 0 s fire as soon as the monkey starts; the getter
    resolves the executor when each fires."""
    with PipelineExecutor([lambda x: x], replicas=[3]) as ex:
        monkey = trt.ChaosMonkey(lambda: ex, [
            trt.ChaosEvent(0.0, "kill_replica", 0, 1),
            trt.ChaosEvent(0.0, "kill_replica", 0, 2),
            trt.ChaosEvent(0.0, "kill_replica", 5, 0)]).start()
        monkey.join(timeout=30)             # due events still fire
        assert [ok for _, ok in monkey.applied] == [True, True, False]
        assert ex.health_snapshot()["live_replicas"] == [1]
        assert ex.submit(7).result(timeout=30) == 7


def _supervise(pkg, tmp_path):
    """10 steps, a checkpoint every 3, one injected failure at step 7:
    restore step 6 and replay."""
    if pkg == "port":
        store, rt = CheckpointStore(str(tmp_path)), trt
        state = {"w": torch.zeros(3), "n": torch.tensor(0)}

        def step_fn(s, step):
            return ({"w": s["w"] + step, "n": s["n"] + 1},
                    {"loss": float(step)})
    else:
        import jax.numpy as jnp
        store, rt = JStore(str(tmp_path)), jrt
        state = {"w": jnp.zeros(3), "n": jnp.array(0)}

        def step_fn(s, step):
            return ({"w": s["w"] + step, "n": s["n"] + 1},
                    {"loss": float(step)})
    sup = rt.TrainSupervisor(store, step_fn, ckpt_every=3,
                             injector=rt.FailureInjector(fail_at_steps=[7]),
                             async_ckpt=False)
    out, rep = sup.run(state, 10)
    return (np.asarray(out["w"]).tolist(), int(out["n"]), rep.final_step,
            rep.restarts, rep.checkpoints, rep.history, store.steps())


def test_supervisor_restarts_from_checkpoint_as_reference(tmp_path):
    got = _supervise("port", tmp_path / "port")
    assert got[:5] == ([45.0] * 3, 10, 10, 1, 4)
    assert got == _supervise("ref", tmp_path / "ref")


def test_supervisor_restarts_clean_on_empty_store(tmp_path):
    failed = []

    def step_fn(state, step):
        if step == 2 and not failed:
            failed.append(step)
            raise OSError("device fell off the bus")
        return state + 1, {}

    store = CheckpointStore(str(tmp_path), keep=2)
    sup = trt.TrainSupervisor(store, step_fn, ckpt_every=100,
                              async_ckpt=False)
    state, rep = sup.run(torch.tensor(0), 5)
    assert rep.restarts == 1 and rep.final_step == 5 and int(state) == 5
    assert store.has_checkpoint()


def test_speculative_executor_prefers_first_success():
    """A primary that fails fast is hedged at once; the backup's success
    wins (the hedge delay is only an upper bound here)."""
    calls = []
    lock = threading.Lock()

    def flaky(x):
        with lock:
            calls.append(x)
            first = len(calls) == 1
        if first:
            raise RuntimeError("transient")
        return x + 1

    se = trt.SpeculativeExecutor(flaky, hedge_after=30.0)
    assert se.submit(1) == 2
    assert (se.hedged, se.completed) == (1, 1)
    assert se.map([3, 4]) == [4, 5] and se.hedged == 1
    se.shutdown()


def test_speculative_executor_raises_when_all_attempts_fail():
    def always(x):
        raise ValueError("both died")

    se = trt.SpeculativeExecutor(always, hedge_after=30.0)
    with pytest.raises(ValueError, match="both died"):
        se.submit(0)
    assert se.hedged == 1
    se.shutdown()


def _sick_probe(pkg):
    """Two replicas of one stage; each fails one item, then replica 0
    succeeds once: a probe at max_consecutive_failures=1 withdraws only
    replica 1."""
    api, rt, ex_cls, _, srv_cls = PKGS[pkg]
    g = (tcnn if pkg == "port" else jcnn).synthetic_cnn(600) \
        .to_layer_graph()
    ep = rt.ElasticPlanner(g, "balanced_norefine")

    def fn(x):
        if x < 0:
            raise ValueError("sick")
        return x

    srv = srv_cls(ep.plan_for(1), [fn], max_batch=4, max_wait_s=0.002)
    srv.executor.stop()
    srv.executor = ex_cls([fn], replicas=[2], name="probe")
    srv.executor.on_stage_lost = srv._notify_stage_lost
    srv.executor.start()
    mon = rt.HealthMonitor(srv, ep, lambda p: [fn] * p.n_stages,
                           policy=rt.FaultPolicy(max_consecutive_failures=1))
    try:
        for x in (-1, -2):                  # round robin: slots 0 and 1
            with pytest.raises(ValueError):
                srv.executor.submit(x).result(timeout=30)
        assert srv.executor.submit(3).result(timeout=30) == 3   # slot 0
        mon._probe()
        return mon.kills, srv.executor.health_snapshot()["live_replicas"]
    finally:
        srv.stop()


def test_health_monitor_probe_withdraws_sick_replica_as_reference():
    got = _sick_probe("port")
    assert got == ([(0, 1, "sick")], [1])
    assert got == _sick_probe("ref")


def _degraded_replan(pkg):
    """Stage 1 of a 3-stage plan dies; the monitor's replan (called as its
    loop calls it on the stage-lost event) shrinks the plan to the 2
    surviving devices and hot-swaps the server, which then serves."""
    api, rt, _, _, srv_cls = PKGS[pkg]
    g = (tcnn if pkg == "port" else jcnn).synthetic_cnn(600) \
        .to_layer_graph()
    ep = rt.ElasticPlanner(g, "balanced_norefine")

    def build(p):
        return [lambda x: x + 1] * p.n_stages

    pl = ep.plan_for(3)
    srv = srv_cls(pl, build(pl), max_batch=4, max_wait_s=0.002)
    srv.executor.start()
    srv.start()
    restores = []
    mon = rt.HealthMonitor(srv, ep, build,
                           warm_restore=lambda: restores.append(1))
    try:
        srv.executor.kill_stage(1)
        stage = mon._events.get(timeout=30)     # the stage-lost event
        mon._replan(stage)
        req = srv.submit(10)
        assert req.event.wait(30) and req.error is None
        replans = [{k: v for k, v in r.items() if k != "replan_s"}
                   for r in mon.replans]
        return replans, list(srv.plan.cuts), req.result, restores
    finally:
        srv.stop()


def test_health_monitor_degraded_replan_as_reference():
    got = _degraded_replan("port")
    assert got[0] == [{"lost_stages": [1], "healthy_devices": 2,
                       "n_stages": 2}]
    assert got[2] == 12 and got[3] == [1]
    assert got == _degraded_replan("ref")
