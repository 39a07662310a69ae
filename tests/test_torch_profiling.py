"""The port's profiler and trace-backed planning against the JAX package's.

* A trace the port's ``profile_model`` captures (here on the CPU; on the
  card in ``chip_smoke.py``) is a ``repro.profile_trace/v1`` document the
  reference's ``ProfileTrace.from_json`` reads, field for field.
* Its depth metadata (levels, layers, params, MACs, weight and activation
  bytes, the low-intensity MAC split) equals the reference profiler's for
  the same model; only the times differ.
* ``trace:`` and ``calibrated:`` plans from one trace file equal the
  reference's plans from the same file: cuts, stage layers, the modeled
  and the trace's stage times and the report (exact); on the reference's
  8 MiB Edge TPU the memory refinement, not the trace, decides ResNet50's
  cuts.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi
from repro.core.edge_tpu_model import EdgeTPUSpec as JSpec
from repro.models import cnn as jcnn
from repro.profiling import ProfileTrace as JTrace
from repro.profiling import profile_model as jprofile
from repro_torch import api as tapi
from repro_torch import profiling as tprof
from repro_torch.core.edge_tpu_model import EdgeTPUSpec as TSpec
from repro_torch.models import cnn as tcnn

CPU = torch.device("cpu")
STATIC = ("depth", "layers", "params", "macs", "weight_bytes", "act_bytes",
          "low_intensity_macs")


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """The port's and the reference's trace of one small synthetic CNN and
    of a small branchy model, and the port's traces saved to files."""
    out = {}
    d = tmp_path_factory.mktemp("traces")
    for key, build in (("chain", lambda pkg: pkg.synthetic_cnn(8, L=4,
                                                               hw=16)),
                       ("mobile", lambda pkg: pkg.REAL_CNNS["MobileNet"]())):
        tm = build(tcnn)
        tr = tprof.profile_model(tm, warmup=1, repeats=3, device=CPU,
                                 stamp_time=False)
        path = str(d / f"{key}.json")
        tr.save(path)
        out[key] = (tm, tr, path)
    return out


def test_port_trace_loads_in_the_reference(traces):
    for tm, tr, path in traces.values():
        with open(path) as f:
            doc = json.load(f)
        assert doc["format"] == "repro.profile_trace/v1"
        jt = JTrace.load(path)
        assert jt.to_dict() == tr.to_dict()
        assert jt.graph_name == tm.name and jt.device == "cpu"
        assert jt.depths == tuple(range(tm.to_layer_graph().depth))
        assert all(s.time_s > 0 and len(s.raw_times_s) == 3
                   for s in jt.samples)
        # and back: the port reads the reference's own document
        assert tprof.ProfileTrace.from_json(jt.to_json()).to_dict() \
            == tr.to_dict()


def test_depth_metadata_equals_reference_profiler():
    tm, jm = tcnn.synthetic_cnn(8, L=4, hw=16), jcnn.synthetic_cnn(8, L=4,
                                                                   hw=16)
    tt = tprof.profile_model(tm, warmup=0, repeats=2, device=CPU,
                             stamp_time=False)
    jt = jprofile(jm, warmup=0, repeats=2, stamp_time=False)
    for key in ("graph_name", "warmup", "repeats", "trim", "batch"):
        assert getattr(tt, key) == getattr(jt, key), key
    assert len(tt.samples) == len(jt.samples)
    for a, b in zip(tt.samples, jt.samples):
        for key in STATIC:
            assert getattr(a, key) == getattr(b, key), key


def test_depth_metadata_of_a_depthwise_model_equals_reference():
    """MobileNet has depthwise layers on both sides of the
    LOW_INTENSITY_MACS_PER_BYTE knee: the split must be the reference's.
    The reference's column is computed from the graph alone, so it is
    compared without running its forwards."""
    from repro.profiling.profiler import LOW_INTENSITY_MACS_PER_BYTE as knee
    assert tprof.profiler.LOW_INTENSITY_MACS_PER_BYTE == knee
    g = jcnn.REAL_CNNS["MobileNet"]().to_layer_graph()
    expect = [sum(g.nodes[n].macs for n in lvl
                  if g.nodes[n].macs <= knee * max(1, g.nodes[n].out_bytes))
              for lvl in g.levels()]
    tm = tcnn.REAL_CNNS["MobileNet"]()
    tt = tprof.profile_model(tm, warmup=0, repeats=1, device=CPU,
                             stamp_time=False)
    got = [s.low_intensity_macs for s in tt.samples]
    assert got == expect and 0 < sum(got) < tm.total_macs
    assert [s.act_bytes for s in tt.samples] == [
        sum(g.nodes[n].out_bytes for n in lvl) for lvl in g.levels()]


@pytest.mark.parametrize("kind", ["trace", "calibrated"])
@pytest.mark.parametrize("strategy,stages", [("balanced_cost", 4),
                                             ("opt", 3), ("balanced", 2)])
@pytest.mark.parametrize("model", ["chain", "mobile"])
def test_trace_plans_equal_reference(traces, kind, strategy, stages, model):
    tm, _, path = traces[model]
    if tm.to_layer_graph().depth <= stages:
        stages = 2
    spec = dict(stages=stages, strategy=strategy,
                cost_source=f"{kind}:{path}")
    graph = tm.to_layer_graph()
    jpl = japi.plan(japi.DeploymentSpec(**spec),
                    graph=jcnn.synthetic_cnn(8, L=4, hw=16).to_layer_graph()
                    if model == "chain"
                    else jcnn.REAL_CNNS["MobileNet"]().to_layer_graph())
    tpl = tapi.plan(tapi.DeploymentSpec(**spec), graph=graph)
    assert tpl.cuts == jpl.cuts
    assert tpl.stage_layers == jpl.stage_layers
    assert tpl.stage_times_s == jpl.stage_times_s
    assert tpl.report.to_dict() == jpl.report.to_dict()
    assert tpl.report.has_trace and tpl.report.cost_source == spec[
        "cost_source"]
    assert "vs trace" in tpl.report.describe()


def test_trace_plan_of_a_model_ref(traces):
    """A ``cnn:`` ref and a trace of that model: the front door resolves
    both without a caller's graph."""
    _, _, path = traces["mobile"]
    spec = dict(model="cnn:MobileNet", stages=4, strategy="balanced_cost",
                cost_source=f"trace:{path}")
    tpl = tapi.plan(tapi.DeploymentSpec(**spec))
    jpl = japi.plan(japi.DeploymentSpec(**spec))
    assert tpl.cuts == jpl.cuts
    assert tpl.report.stage_time_error_pct == jpl.report.stage_time_error_pct
    assert np.isfinite(tpl.report.stage_time_error_pct)


def test_malformed_cost_sources_raise_at_construction():
    for bad in ("trace", "trace:", "analytic:x", "measured:x"):
        with pytest.raises(ValueError):
            tapi.DeploymentSpec(cost_source=bad)


def test_live_trace_builder_is_not_ported():
    """Pinned the raise while ``profiling/live.py`` was unported; it is
    ported now (held against the reference in
    ``tests/test_torch_selfheal.py``): the package exports the port's own
    class, not the reference's, and an unknown name raises
    ``AttributeError`` instead of the old ``NotImplementedError``."""
    from repro.profiling import LiveTraceBuilder as JLive
    from repro_torch.profiling.live import LiveTraceBuilder
    assert tprof.LiveTraceBuilder is LiveTraceBuilder is not JLive
    assert "LiveTraceBuilder" in tprof.__all__
    with pytest.raises(AttributeError):
        tprof.NoSuchSource


def test_memory_refinement_decides_the_cuts_on_the_edge_tpu(tmp_path):
    """A flat trace of ResNet50 (every depth level 0.07 ms): balanced_cost
    splits the measured time evenly, [40, 82, 124], when each stage has a
    quarter of an 80 GB card; planned for the reference's 8 MiB Edge TPU,
    the default refinement moves the cuts to [84, 134, 147] so that every
    stage's int8 weights fit, whatever the trace says.  Both plans equal
    the reference's."""
    g = tcnn.REAL_CNNS["ResNet50"]().to_layer_graph()
    samples = tuple(
        tprof.DepthSample(depth=d, time_s=7e-5, layers=tuple(lvl),
                          params=g.params_per_depth()[d],
                          macs=g.macs_per_depth()[d],
                          weight_bytes=g.bytes_per_depth()[d])
        for d, lvl in enumerate(g.levels()))
    path = str(tmp_path / "flat.json")
    tprof.ProfileTrace(graph_name=g.name, samples=samples,
                       device="flat").save(path)
    spec = dict(model="cnn:ResNet50", stages=4, strategy="balanced_cost",
                cost_source=f"trace:{path}")
    card = 80 * 2 ** 30 // 4
    edge = tapi.plan(tapi.DeploymentSpec(**spec))
    big = tapi.plan(tapi.DeploymentSpec(**spec),
                    base_spec=TSpec(onchip_bytes=card))
    assert list(edge.cuts) == [84, 134, 147]
    assert list(big.cuts) == [40, 82, 124]
    assert max(edge.report.stage_params) <= 8 * 2 ** 20
    trace_ms = big.report.trace_stage_times_s
    assert max(trace_ms) - min(trace_ms) < 1e-4       # 2 levels of 0.07 ms
    assert edge.cuts == japi.plan(japi.DeploymentSpec(**spec)).cuts
    assert big.cuts == japi.plan(japi.DeploymentSpec(**spec),
                                 base_spec=JSpec(onchip_bytes=card)).cuts
