"""The ``mobilenetv2-offline-b1024`` cell at a small size on the CPU: its
reference against the port's forward and layer graph, its counts, a
sound run and planted faults, and the two readers of the depthwise span
on a trace made by hand."""
from types import SimpleNamespace as NS

import pytest
import torch
from torch.autograd import DeviceType

from portbench import control, harness
from portbench.reference import mobilenetv2
from portbench.trace import Trace
from repro_torch.kernels import ref as kref
from repro_torch.launch import pipeline_spmd
from repro_torch.models import cnn, layers
from repro_torch.models.layers import DWCONV_SPAN

from .cells import ROOT

MOBILENET = "mobilenetv2-offline-b1024"
SEED = 2 ** 31 + 4321
READERS = ("dwconv_ms_per_image.images", "dwconv_roofline.images")


def small() -> harness.Cell:
    """The cell at 4 images a batch in 2 microbatches, 224 x 224 x 3."""
    cell = harness.resolve(harness.load_bench(ROOT), MOBILENET,
                           ROOT / "portbench")
    cell.traffic.update(batch=4, microbatches=2, pool=2, warmup_batches=0,
                        check={"batches": 2})
    cell.check["rows"] = 4
    return cell


@pytest.fixture(scope="module")
def model():
    return small().config["model"]


@pytest.fixture(scope="module")
def net():
    return cnn.REAL_CNNS["MobileNetV2"]()


def images(n):
    return torch.randn((n, 224, 224, 3),
                       generator=torch.Generator().manual_seed(3))


def test_the_reference_matches_the_port_forward(model, net):
    params = mobilenetv2.make_params(model, 2 ** 31 + 9, "cpu")
    x = images(2)
    clipped = {}
    with torch.no_grad():
        got = net.apply(params, x)
        ref = mobilenetv2.forward(model, params, x, clipped=clipped)
    assert got.shape == ref.shape == (2, model["classes"])
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5
    # the ReLU6 ceiling clips in every one of the 35, so a ReLU6 that
    # became a ReLU shows
    assert len(clipped) == 35
    assert min(clipped.values()) >= 0.01


def test_check_names_holds_and_refuses_another_order(model, net):
    mobilenetv2.check_names(model, net._order)
    with pytest.raises(ValueError):
        mobilenetv2.check_names(model, net._order[1:])
    with pytest.raises(ValueError):
        mobilenetv2.check_names(model, cnn.REAL_CNNS["ResNet50"]()._order)


def test_the_counts_are_the_port_layer_graph(model, net):
    graph = net.to_layer_graph()
    macs = mobilenetv2.macs_per_image(model)
    port = {name: node.macs for name, node in graph.nodes.items()
            if node.macs}
    assert macs == port
    assert sum(macs.values()) == 300_774_272
    assert mobilenetv2.model_flops_per_image(model) == 2 * sum(port.values())
    shapes = mobilenetv2.shapes(model)
    assert all(shapes[n] == tuple(net.nodes[n].out_shape)
               for n in net._order)


@pytest.mark.parametrize("mb", [256, 3])
def test_conv_costs_are_twice_the_macs_over_the_images(model, net, mb):
    macs = mobilenetv2.macs_per_image(model)
    convs = [n for n in net._order if net.nodes[n].kind == "conv"]
    dw = [n for n in convs if n.endswith("_dw")]
    assert (len(convs), len(dw)) == (52, 17)
    costs = mobilenetv2.conv_costs(model, mb)
    assert [f for f, _ in costs] == [2 * mb * macs[n] for n in convs]
    dw_costs = mobilenetv2.dwconv_costs(model, mb)
    assert dw_costs == [costs[convs.index(n)] for n in dw]
    shapes = mobilenetv2.shapes(model)
    for n, (f, b) in zip(dw, dw_costs):
        (src,) = net.nodes[n].inputs
        h, w, c = shapes[src]
        ho, wo, _ = shapes[n]
        # one 3x3 filter a channel: input, weight and output once each
        assert f == 2 * mb * ho * wo * c * 9
        assert b == 4 * (mb * h * w * c + c * 9 + mb * ho * wo * c)


def run(cell=None):
    return harness.run_cell(cell or small(), SEED, 0.2, False, device="cpu")


def test_a_sound_run_is_correct():
    res = run()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["checks"]["max_rel_err"]["value"] < 1e-6


def zero_hop(x, done, device, stream):
    return torch.zeros_like(x, device=device)


def swapped_answer(call):
    def swapped(self, batch):
        out = call(self, batch).clone()
        out[[0, 1]] = out[[1, 0]]
        return out
    return swapped


def relu_projection(fn):
    """The BN epilogue with a ReLU where the graph gives none: every
    linear bottleneck's projection BN (and its add) rectified."""
    def wrong(x, mean, var, gamma, beta, r=None, act=None):
        return fn(x, mean, var, gamma, beta, r, act or "relu")
    return wrong


@pytest.mark.parametrize("fault", ["zero_hop", "swapped_answer",
                                   "relu6_as_relu", "relu_projection"])
def test_a_broken_path_is_not_correct(fault, monkeypatch):
    if fault == "zero_hop":
        monkeypatch.setattr(pipeline_spmd, "_hop", zero_hop)
    elif fault == "swapped_answer":
        cls = pipeline_spmd.SpmdPipelineExecutor
        monkeypatch.setattr(cls, "__call__", swapped_answer(cls.__call__))
    elif fault == "relu6_as_relu":
        # the fused groups' and the lone act nodes' ReLU6 alike (the act
        # nodes take theirs when the network is built, in the run)
        monkeypatch.setitem(kref.EPILOGUE_ACTS, "relu6", torch.relu)
    else:
        monkeypatch.setattr(layers, "bn_epilogue",
                            relu_projection(layers.bn_epilogue))
    res = run()
    assert not res["correct"], res["checks"]


def test_the_control_is_not_correct():
    cell = small()
    numbers = control.control_numbers(cell, SEED, "cpu")
    limits = {k: v["limit"] for k, v in cell.check["numbers"].items()}
    assert any(numbers[k] > limits[k] for k in limits), numbers


# ---------------------------------------------------------------------------
# the readers of the depthwise span
# ---------------------------------------------------------------------------
def cpu(name, lo, hi, parent=None, kernels=()):
    return NS(name=name, device_type=DeviceType.CPU,
              time_range=NS(start=lo, end=hi), cpu_parent=parent,
              kernels=[NS(duration=d) for d in kernels])


def fake_trace(spans=True):
    """Two traced batches: four depthwise calls, each a pad of 2 µs and a
    convolution of 10 µs (a transpose of 3 µs under the second's
    ``aten::conv2d``), and a 1x1 convolution of 50 µs outside the span."""
    events = []
    for i in range(4):
        t0 = 100.0 * i
        dw = cpu(DWCONV_SPAN, t0, t0 + 40) if spans else None
        conv = cpu("aten::conv2d", t0 + 10, t0 + 30, dw)
        events += [e for e in (dw, conv) if e is not None]
        events += [cpu("aten::constant_pad_nd", t0 + 1, t0 + 5, dw, (2.0,)),
                   cpu("aten::cudnn_convolution", t0 + 11, t0 + 29, conv,
                       (10.0,) if i != 1 else (7.0, 3.0))]
    events.append(cpu("aten::cudnn_convolution", 450, 500, None, (50.0,)))
    events.append(NS(name="kernel", device_type=DeviceType.CUDA,
                     device_index=0, time_range=NS(start=0, end=500),
                     cpu_parent=None, kernels=[]))
    return Trace(NS(events=lambda: events), 600e-6, [0])


@pytest.fixture
def tiny():
    """The cell with a one-block network of 8 x 8 x 3 images, batches of
    4 in 2 microbatches: its one depthwise call over 2 images of (4, 4,
    32) is 2 x 2 x 4 x 4 x 32 x 9 = 18432 FLOPs and 4 x (2 x 512 + 288 +
    2 x 512) = 9344 bytes."""
    cell = small()
    cell.config["model"].update(blocks=[[1, 16, 1, 1]], input_shape=[8, 8, 3])
    return cell


def reader(cell, name):
    return next(m["read"] for m in cell.metrics if m["name"] == name)


def run_of(cell, trace):
    r = harness.Run(cell, 0, 1.0, 2.0, [0.1] * 6, {"images": 4}, [3, 4],
                    trace=trace)
    r.peaks = {"fp32_flops": 1e10, "hbm_bytes_per_s": 1e9}
    return r


def test_the_cell_resolves_both_readers():
    got = {m["name"]: m for m in small().metrics if m["name"] in READERS}
    assert sorted(got) == sorted(READERS)
    for m in got.values():
        assert m["kind"] == "per_layer" and m["source"] == "device_trace"
        assert m["moves"] == "images_per_s"
        assert m["workloads"] == [MOBILENET]


@pytest.mark.parametrize("name,expect", [
    # 4 x (2 + 10) µs over 2 batches of 4 images
    ("dwconv_ms_per_image.images", 48e-3 / 8),
    # 2 batches x 2 microbatches of one call, each max(18432 / 1e10,
    # 9344 / 1e9) s = 9.344 µs, over the 48 µs
    ("dwconv_roofline.images", 100 * 4 * 9.344 / 48),
])
def test_each_reader_gives_the_value_worked_out_by_hand(tiny, name, expect):
    assert reader(tiny, name)(run_of(tiny, fake_trace())) == \
        pytest.approx(expect, rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_nothing_without_a_trace_or_its_span(tiny, name):
    read = reader(tiny, name)
    assert read(run_of(tiny, None)) is None
    assert read(run_of(tiny, fake_trace(spans=False))) is None
