"""The CNN forward's depthwise span (``models/layers.py`` ``DWCONV_SPAN``)
on the CPU: a grouped convolution runs its pad and its ``conv2d`` inside
``cnn.dwconv`` (a depthwise one also the BN and activation its group takes
in), an ungrouped one opens nothing, decided when the network is built;
so MobileNetV2's forward opens 17 and ResNet50's none, also through the
SPMD tier's stages."""
import collections

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.launch import pipeline_spmd as spmd  # noqa: E402
from repro_torch.models import cnn, layers  # noqa: E402
from repro_torch.models.layers import DWCONV_SPAN  # noqa: E402

CPU = torch.device("cpu")


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _forward(name, n=1):
    net = cnn.REAL_CNNS[name]()
    params = net.init(CPU, torch.Generator().manual_seed(0))
    x = torch.randn((n,) + net.input_shape,
                    generator=torch.Generator().manual_seed(1))
    return net, params, x


@pytest.mark.parametrize("name,spans", [("MobileNetV2", 17),
                                        ("ResNet50", 0)])
def test_a_profiled_forward_opens_a_span_a_depthwise_conv(name, spans):
    net, params, x = _forward(name)
    with torch.no_grad():
        expect = net.apply(params, x)
        got, events = _profiled(lambda: net.apply(params, x))
    assert torch.equal(got, expect)
    mine = [e for e in events if e.name == DWCONV_SPAN]
    assert len(mine) == spans
    # the layout views, the pad and the convolution run inside it, and the
    # BN and ReLU6 that each depthwise conv's group takes in
    inside = collections.Counter(
        e.name for e in events
        if e.cpu_parent is not None and e.cpu_parent.name == DWCONV_SPAN)
    one = {"aten::permute": 2, "aten::pad": 1, "aten::conv2d": 1,
           "aten::add": 2, "aten::rsqrt": 1, "aten::sub": 1, "aten::mul": 2,
           "aten::clamp": 1}
    assert inside == {op: n * spans for op, n in one.items() if spans}


def test_the_span_is_chosen_when_the_node_is_built(monkeypatch):
    """Without a profiler an ungrouped conv never asks for a span, and a
    grouped one asks once a call."""
    asked, real = [], layers.span

    def record(name):
        asked.append(name)
        return real(name)

    monkeypatch.setattr(layers, "span", record)
    for name, calls in (("ResNet50", 0), ("MobileNetV2", 17)):
        asked.clear()
        net, params, x = _forward(name)
        with torch.no_grad():
            net.apply(params, x)
        assert asked == [DWCONV_SPAN] * calls


def test_the_spmd_stages_open_the_span_a_depthwise_conv_a_microbatch():
    net, params, x = _forward("MobileNetV2", 2)
    plan = api.plan(api.DeploymentSpec(stages=4, strategy="balanced"),
                    graph=net.to_layer_graph())
    with spmd.SpmdPipelineExecutor.for_cnn(
            net, params, plan, mesh=spmd.default_stage_mesh(4, "cpu"),
            n_microbatches=2, batch_size=2) as ex:
        expect = ex(x)
        got, events = _profiled(lambda: ex(x))
    assert torch.equal(got, expect)
    by_stage = collections.Counter(
        e.cpu_parent.name for e in events if e.name == DWCONV_SPAN)
    assert sum(by_stage.values()) == 2 * 17
    assert set(by_stage) <= set(spmd.stage_spans(4))


@pytest.fixture
def sm90():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        yield torch.device("cuda")


@pytest.mark.cuda
def test_on_the_card_the_span_holds_one_dwconv_kernel(sm90):
    """A MobileNetV2 forward on the card: each of the 17 spans holds the
    kernels of its depthwise conv and the BN and ReLU6 after it, which are
    one ``dwconv`` launch and no pad, fill, cuDNN or ``bn_epilogue``
    kernel."""
    net = cnn.REAL_CNNS["MobileNetV2"]()
    params = net.init(sm90, torch.Generator(sm90).manual_seed(0))
    x = torch.randn((2,) + net.input_shape, device=sm90,
                    generator=torch.Generator(sm90).manual_seed(1))
    with torch.no_grad():
        net.apply(params, x)                # builds the kernels
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            net.apply(params, x)
            torch.cuda.synchronize()
    events = prof.events()
    spans = {id(e): [] for e in events if e.name == DWCONV_SPAN}
    assert len(spans) == 17
    for e in events:
        p = e
        while p is not None and p.name != DWCONV_SPAN:
            p = p.cpu_parent
        if p is not None:
            spans[id(p)] += [k.name for k in e.kernels]
    assert all(len(names) == 1 and "dwconv_kernel" in names[0]
               for names in spans.values()), list(spans.values())
