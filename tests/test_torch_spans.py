"""The program's profiler spans (``profiling/spans.py``) and where the SPMD
tier opens them (``launch/pipeline_spmd.py``), on the CPU.

* With no profiler running, ``span`` hands back one shared null context
  and makes no ``RecordFunction``.
* Under the profiler it makes one CPU event of function scope, not a
  user annotation (which the trace would repeat on the device timeline),
  and the operators run inside it take it as their parent.
* A profiled CNN executor call opens one ``spmd.call``, S x M stage spans
  under it, one boundary span under each stage span (the choice of the
  tensors it hands on) and two directly under the call (the input wrap
  and the output pick), and returns what an unprofiled call returns.
"""
import collections

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import api
from repro_torch.launch import pipeline_spmd as spmd
from repro_torch.models import cnn
from repro_torch.profiling import spans

CPU = torch.device("cpu")


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def test_span_without_a_profiler_is_one_shared_null_context(monkeypatch):
    def no_record_function(name):
        raise AssertionError(f"a RecordFunction for {name!r}")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        no_record_function)
    assert not torch.autograd._profiler_enabled()
    a, b = spans.span("test.a"), spans.span("test.b")
    assert a is b
    with a:
        torch.ones(2).add_(1)


def test_span_under_the_profiler_is_one_cpu_event_not_a_user_annotation():
    def work():
        with spans.span("test.span"):
            return torch.ones(4) + 1

    _, events = _profiled(work)
    mine = [e for e in events if e.name == "test.span"]
    assert len(mine) == 1
    assert mine[0].device_type == DeviceType.CPU
    assert not mine[0].is_user_annotation
    add = next(e for e in events if e.name == "aten::add")
    assert add.cpu_parent is mine[0]


def test_stage_spans_are_made_once_a_stage_count():
    names = spmd.stage_spans(3)
    assert names == ("spmd.stage.0", "spmd.stage.1", "spmd.stage.2")
    assert spmd.stage_spans(3) is names
    assert all(n.startswith(spmd.STAGE_SPAN) for n in names)


def _span_tree(events):
    """(name, parent name) -> count of the events whose name starts with
    ``spmd.``."""
    return collections.Counter(
        (e.name, e.cpu_parent.name if e.cpu_parent else None)
        for e in events if e.name.startswith("spmd."))


@pytest.mark.parametrize("width,layers,hw,stages,m,batch", [
    (4, 5, 16, 2, 2, 4),
    (8, 6, 32, 4, 4, 4),
], ids=["2_stages", "4_stages"])
def test_a_profiled_cnn_call_opens_its_spans(width, layers, hw, stages, m,
                                             batch):
    model = cnn.synthetic_cnn(width, L=layers, hw=hw)
    plan = api.plan(api.DeploymentSpec(stages=stages,
                                       strategy="balanced_norefine"),
                    graph=model.to_layer_graph())
    params = model.init(CPU, torch.Generator().manual_seed(0))
    x = torch.randn((batch,) + tuple(model.input_shape),
                    generator=torch.Generator().manual_seed(1))
    with spmd.SpmdPipelineExecutor.for_cnn(
            model, params, plan, mesh=spmd.default_stage_mesh(stages, "cpu"),
            n_microbatches=m, batch_size=batch) as ex:
        expect = ex(x)
        got, events = _profiled(lambda: ex(x))
    assert torch.equal(got, expect)
    tree = _span_tree(events)
    want = {(spmd.CALL_SPAN, None): 1,
            (spmd.BOUNDARY_SPAN, spmd.CALL_SPAN): 2}
    for name in spmd.stage_spans(stages):
        want[name, spmd.CALL_SPAN] = m
        want[spmd.BOUNDARY_SPAN, name] = m
    assert tree == want


def test_the_schedule_opens_a_stage_span_a_microbatch_without_a_call():
    """The LM lowering shares the schedule: its stages get their spans
    from ``_gpipe_outputs`` alone."""
    fns = [lambda x, k=k: x + k for k in range(3)]
    x_all = torch.zeros(2, 5)
    got, events = _profiled(lambda: spmd._gpipe_outputs(
        fns, [None] * 3, x_all, x_all.shape))
    assert torch.equal(got, torch.full((2, 5), 3.0))
    assert _span_tree(events) == {(name, None): 2
                                  for name in spmd.stage_spans(3)}
