"""The four readers of the SPMD tier's spans, on a trace made by hand:
two executor calls of a 2-stage plan on two cards, with known kernels
under each span, device intervals, and launch calls inside and outside
the calls.  Each reader returns the value worked out by hand, and nothing
without a trace or on a trace whose program opens no spans (the parent
of the change that added them)."""
from types import SimpleNamespace as NS

import pytest
from torch.autograd import DeviceType

from portbench import harness
from portbench.trace import Trace
from repro_torch.launch.pipeline_spmd import (BOUNDARY_SPAN, CALL_SPAN,
                                              stage_spans)

from .cells import RESNET, ROOT

NAMES = ("stage_imbalance.images", "boundary_ms_per_image.images",
         "call_idle.images", "launches_per_image.images")
STAGE0, STAGE1 = stage_spans(2)


def cpu(name, lo, hi, parent=None, kernels=()):
    return NS(name=name, device_type=DeviceType.CPU,
              time_range=NS(start=lo, end=hi), cpu_parent=parent,
              kernels=[NS(duration=d) for d in kernels])


def dev(card, lo, hi, name="kernel"):
    return NS(name=name, device_type=DeviceType.CUDA, device_index=card,
              time_range=NS(start=lo, end=hi), cpu_parent=None, kernels=[])


def op(name, lo, hi, parent, kernel, launch="cudaLaunchKernel"):
    """An operator with one kernel of ``kernel`` µs, and its launch."""
    e = cpu(name, lo, hi, parent, (kernel,))
    return [e, cpu(launch, lo + 0.1, lo + 0.2, e)]


def call(t0, spans=True):
    """One executor call at ``t0`` µs: per stage-0 microbatch 1 + 20 + 2
    µs of kernels (2 + 1 of them boundary), per stage-1 one 5 + 1 (1
    boundary), 3 µs of input packing; 6 launches."""
    def span(name, lo, hi, parent):
        return cpu(name, t0 + lo, t0 + hi, parent) if spans else parent

    c = span(CALL_SPAN, 0, 100, None)
    pack_in = span(BOUNDARY_SPAN, 1, 5, c)
    s0 = span(STAGE0, 5, 40, c)
    b0, b1 = span(BOUNDARY_SPAN, 6, 8, s0), span(BOUNDARY_SPAN, 30, 35, s0)
    s1 = span(STAGE1, 40, 90, c)
    b2 = span(BOUNDARY_SPAN, 80, 85, s1)
    out = [span(BOUNDARY_SPAN, 90, 95, c)]
    events = [e for e in (c, pack_in, s0, b0, b1, s1, b2, *out)
              if e is not None and spans]
    events += op("aten::copy_", t0 + 2, t0 + 4, pack_in, 3.0)
    events += op("aten::copy_", t0 + 6.5, t0 + 7.5, b0, 1.0)
    events += op("aten::cudnn_convolution", t0 + 10, t0 + 30, s0, 20.0,
                 launch="cuLaunchKernel")
    events += op("aten::copy_", t0 + 31, t0 + 34, b1, 2.0)
    events += op("aten::cudnn_convolution", t0 + 45, t0 + 75, s1, 5.0)
    events += op("aten::copy_", t0 + 81, t0 + 84, b2, 1.0)
    return events


def fake_trace(spans=True):
    events = call(0, spans) + call(200, spans)
    # the loop's keep, outside the calls: a kernel and its launch
    events += op("aten::copy_", 120, 130, None, 4.0)
    for t0 in (0, 200):
        events += [dev(0, t0 + 3, t0 + 10), dev(0, t0 + 5, t0 + 8),
                   dev(0, t0 + 12, t0 + 50), dev(0, t0 + 60, t0 + 95)]
    events += [dev(0, 120, 130), dev(1, 0, 100)]
    return Trace(NS(events=lambda: events), 400e-6, [0, 1])


@pytest.fixture
def cell():
    cell = harness.resolve(harness.load_bench(ROOT), RESNET,
                           ROOT / "portbench")
    cell.config["plan"]["stages"] = 2
    return cell


def readers(cell):
    return {m["name"]: m["read"] for m in cell.metrics if m["name"] in NAMES}


def run_of(cell, trace):
    return harness.Run(cell, 0, 1.0, 2.0, [0.1] * 6, {"images": 4}, [3, 4],
                       trace=trace)


def test_the_cell_resolves_all_four_readers(cell):
    got = {m["name"]: m for m in cell.metrics if m["name"] in NAMES}
    assert sorted(got) == sorted(NAMES)
    for m in got.values():
        assert m["kind"] == "per_layer" and m["source"] == "device_trace"
        assert m["moves"] == "images_per_s" and m["better"] == "lower"
        assert m["workloads"] == [RESNET]


@pytest.mark.parametrize("name,expect", [
    # stages: 2 x (1 + 20 + 2) = 46 and 2 x (5 + 1) = 12 µs, mean 29
    ("stage_imbalance.images", 46 / 29),
    # 2 x (3 + 1 + 2 + 1) µs over 2 batches of 4 images
    ("boundary_ms_per_image.images", 14e-3 / 8),
    # card 0 idles 100 - (7 + 38 + 35) µs a call, card 1 0 and 100:
    # (40 + 100) / 2 over 400 µs
    ("call_idle.images", 70 / 400),
    # 6 launches a call under spmd.call, the keep's left out
    ("launches_per_image.images", 12 / 8),
])
def test_each_reader_gives_the_value_worked_out_by_hand(cell, name, expect):
    assert readers(cell)[name](run_of(cell, fake_trace())) == \
        pytest.approx(expect, rel=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_each_reader_reads_nothing_without_a_trace_or_its_spans(cell, name):
    read = readers(cell)[name]
    assert read(run_of(cell, None)) is None
    assert read(run_of(cell, fake_trace(spans=False))) is None
