"""The depthwise convolution kernel (``kernels/dwconv.py``,
``csrc/dwconv.cu``), its BN epilogue, and its place in the CNN forward.

On the CPU, with no JAX (the plain version is the forward's own ops):
``dwconv_ref`` is the ``F.pad`` and grouped ``F.conv2d`` route bit for
bit at every distinct depthwise convolution of ``cnn.REAL_CNNS``, and with
a BN the same route then ``bn_epilogue_ref``; each of those passes the
wrapper's checks on ``meta`` tensors and gets its output shape and cost
(the epilogue's with a BN); what the kernel does not take raises; a
MobileNetV2 forward calls the wrapper once a depthwise convolution (17,
each with its BN and ReLU6), ResNet50's never, and a forward that records
autograd runs the plain ops.

Marked ``cuda`` (skip without a card of compute capability 9.0):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_dwconv.py

the kernel against the plain ops (``F.pad`` and cuDNN's grouped route,
fp32, TF32 off) within 4 ulp of the output's scale (4 x fp32's eps x max
|plain|: the two sum the k * k products in other orders) at MobileNetV2's
17 convolutions at the benchmark's microbatch of 256, at k 5, k 7, odd
sizes, a bias and no padding; 17 launches a MobileNetV2 forward; and a
MobileNetV2 forward through the SPMD tier against the plain route within
the benchmark cell's 1.5e-5 of max |y|.  The epilogue: a launch with the
BN and activation equal bit for bit to ``dwconv`` then ``bn_epilogue`` on
the card at those 17 convolutions with ReLU6 and at k 5, k 7 and stride 2
with and without a bias and each activation, a NaN and the ReLU6 ceiling
as ``bn_epilogue`` gives them, its refusals, and a MobileNetV2 forward of
17 launches with it and 35 ``bn_epilogue`` launches (52 without it).
"""
import math
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import bn_epilogue as be  # noqa: E402
from repro_torch.kernels import dwconv as dw  # noqa: E402
from repro_torch.kernels.ref import bn_epilogue_ref, dwconv_ref  # noqa: E402
from repro_torch.launch import pipeline_spmd as spmd  # noqa: E402
from repro_torch.models import cnn, layers  # noqa: E402

CPU = torch.device("cpu")
META = torch.device("meta")
ULPS = 4
SPMD_TOL = 1.5e-5     # the mobilenetv2 cell's limit on max_rel_err


def _depthwise_convs(names):
    """(H, W, C, k, stride, pads) of each depthwise conv the builders of
    ``names`` make, in order; pads in ``F.pad``'s order (left, right, top,
    bottom)."""
    found = []
    real = layers.Builder.conv

    def conv(self, x, filters, kernel, stride=1, padding="same",
             use_bias=True, name=None, groups=1):
        h, w, c = self.model.shape_of(x)
        if groups > 1:
            assert groups == c == filters       # multiplier 1, all of them
            assert padding == "same" and not use_bias
            (pt, pb), (pl, pr) = (layers.same_pads(h, kernel, stride),
                                  layers.same_pads(w, kernel, stride))
            found.append((h, w, c, kernel, stride, (pl, pr, pt, pb)))
        return real(self, x, filters, kernel, stride, padding, use_bias,
                    name, groups)

    with mock.patch.object(layers.Builder, "conv", conv):
        for name in names:
            cnn.REAL_CNNS[name]()
    return found


ZOO = sorted(set(_depthwise_convs(cnn.REAL_CNNS)))
MOBILENETV2 = _depthwise_convs(["MobileNetV2"])
# k 5 and 7, odd and small sizes, strides 1 and 2 (the first five from
# the zoo), at a few images
ODD = [(111, 111, 32, 5, 2), (56, 56, 44, 5, 1), (65, 65, 144, 5, 2),
       (147, 147, 64, 3, 1), (19, 19, 728, 3, 1), (9, 9, 1392, 5, 1),
       (15, 15, 16, 7, 1), (15, 15, 16, 7, 2), (3, 5, 8, 3, 2),
       (1, 1, 4, 3, 1)]


def _ids(cases):
    return ["x".join(map(str, c[:4])) + f"s{c[4]}" for c in cases]


def _same(h, w, k, stride):
    (pt, pb), (pl, pr) = (layers.same_pads(h, k, stride),
                          layers.same_pads(w, k, stride))
    return pl, pr, pt, pb


def _inputs(dev, n, h, w, c, k, bias=False, seed=0):
    """x (n, h, w, c) and the parameter as the forward holds it: w (c, 1,
    k, k) channels_last, scaled by fan-in ** -0.5; b or None."""
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn((n, h, w, c), generator=g, device=dev)
    wt = (torch.randn((c, 1, k, k), generator=g, device=dev) / k).contiguous(
        memory_format=torch.channels_last)
    b = torch.randn(c, generator=g, device=dev) if bias else None
    return x, wt, b


def _bn(dev, c, seed=1):
    """Per-channel (mean, var, gamma, beta) drawn at random, scaled so that
    a depthwise output of unit scale crosses ReLU6's 0 and 6."""
    g = torch.Generator().manual_seed(seed)
    return tuple(t.to(dev) for t in (
        torch.randn(c, generator=g) * 0.5,
        torch.rand(c, generator=g) * 0.1 + 0.01,
        torch.rand(c, generator=g) * 2 + 0.5,
        torch.randn(c, generator=g) * 2))


def _route_before(x, w, b, stride, pads):
    """The forward's depthwise ops before the kernel, written out."""
    v = layers._nchw(x)
    if any(pads):
        v = F.pad(v, pads)
    return layers._nhwc(F.conv2d(v, w, b, stride=stride, groups=x.shape[-1]))


# -- the CPU ------------------------------------------------------------------
def test_the_zoo_has_depthwise_convs_at_k3_and_k5_strides_1_and_2():
    assert len(MOBILENETV2) == 17
    assert {(k, s) for _, _, _, k, s, _ in ZOO} == {(3, 1), (3, 2), (5, 1),
                                                    (5, 2)}
    assert any(h % 2 for h, *_ in ZOO) and any(h % 2 == 0 for h, *_ in ZOO)


@pytest.mark.parametrize("case", ZOO, ids=_ids(ZOO))
def test_dwconv_ref_is_the_pad_and_grouped_conv_route(case):
    h, w, c, k, stride, pads = case
    x, wt, _ = _inputs(CPU, 2, h, w, c, k)
    expect = _route_before(x, wt, None, stride, pads)
    assert torch.equal(dwconv_ref(x, wt, None, stride, pads), expect)
    assert torch.equal(dw.dwconv(x, wt, None, stride, pads), expect)


@pytest.mark.parametrize("case", ZOO, ids=_ids(ZOO))
def test_every_zoo_depthwise_conv_passes_the_kernels_checks(case):
    """On ``meta``: the output's shape, contiguous, the cost reported, no
    launch."""
    h, w, c, k, stride, pads = case
    x = torch.empty((2, h, w, c), device=META)
    wt = torch.empty((c, 1, k, k), device=META).contiguous(
        memory_format=torch.channels_last)
    costs = []
    before = _build.launches("dwconv")
    with _build.cost_sink(lambda *a: costs.append(a)):
        y = dw.dwconv(x, wt, None, stride, pads)
    oh, ow = -(-h // stride), -(-w // stride)
    assert y.shape == (2, oh, ow, c) and y.is_contiguous()
    assert costs == [("dwconv", 2 * k * k * 2 * oh * ow * c,
                      4 * (2 * h * w * c + c * k * k + 2 * oh * ow * c))]
    assert _build.launches("dwconv") == before


def test_dwconv_cost_counts_a_bias():
    x = torch.empty((3, 10, 10, 8), device=META)
    assert dw.dwconv_cost(x, 3, 5, 5, True) == (
        19 * 3 * 5 * 5 * 8, 4 * (2400 + 72 + 600 + 8))


@pytest.mark.parametrize("act", [None, "relu", "relu6"])
def test_dwconv_cost_counts_the_bn_epilogue(act):
    """4 more flops an output (5 with an activation) and the 4 per-channel
    vectors read once: on ``meta`` the call reports it."""
    x = torch.empty((3, 10, 10, 8), device=META)
    ops = 18 + 4 + (act is not None)
    expect = (ops * 3 * 5 * 5 * 8, 4 * (2400 + 72 + 600 + 4 * 8))
    assert dw.dwconv_cost(x, 3, 5, 5, False, True, act) == expect
    wt = torch.empty((8, 1, 3, 3), device=META)
    costs = []
    with _build.cost_sink(lambda *a: costs.append(a)):
        y = dw.dwconv(x, wt, None, 2, (0, 1, 0, 1), _bn(META, 8), act)
    assert y.shape == (3, 5, 5, 8) and costs == [("dwconv", *expect)]


@pytest.mark.parametrize("act", [None, "relu", "relu6"])
@pytest.mark.parametrize("bias", [False, True])
def test_cpu_route_with_a_bn_is_the_plain_ops(act, bias):
    """The conv's ``F.pad`` and grouped ``F.conv2d``, then
    ``bn_epilogue_ref``: the nodes' own ops, bit for bit."""
    x, wt, b = _inputs(CPU, 2, 9, 9, 16, 3, bias=bias)
    ps = _bn(CPU, 16)
    pads = _same(9, 9, 3, 2)
    y = dw.dwconv(x, wt, b, 2, pads, ps, act)
    expect = bn_epilogue_ref(_route_before(x, wt, b, 2, pads), *ps, act=act)
    assert torch.equal(y, expect)
    assert torch.equal(y, dwconv_ref(x, wt, b, 2, pads, ps, act))


# (case, the error): what the kernel does not take raises off the CPU, and
# nothing is counted
REFUSED = [("float64", TypeError), ("weight_bfloat16", TypeError),
           ("transposed", ValueError), ("c30", ValueError),
           ("2_31_elements", ValueError), ("multiplier_2", ValueError),
           ("two_inputs_a_group", ValueError), ("k4", ValueError),
           ("k3x5", ValueError), ("stride3", ValueError),
           ("pad_of_k", ValueError), ("bias_of_c2", ValueError),
           ("no_output", ValueError), ("weight_on_cpu", ValueError),
           ("requires_grad", RuntimeError), ("bn_float64", TypeError),
           ("bn_of_c2", ValueError), ("bn_strided", ValueError),
           ("bn_on_cpu", ValueError), ("act_without_bn", ValueError),
           ("act_swish", ValueError), ("bn_requires_grad", RuntimeError)]


def _refused_case(case):
    """The arguments of one refused call, on ``meta``."""
    dev = META
    x = torch.empty((2, 8, 8, 16), device=dev)
    wt = torch.empty((16, 1, 3, 3), device=dev)
    b, stride, pads = None, 1, (1, 1, 1, 1)
    bn, act = list(_bn(dev, 16)), "relu6"
    if case == "float64":
        x = x.double()
    elif case == "weight_bfloat16":
        wt = wt.bfloat16()
    elif case == "transposed":
        x = x.transpose(1, 2)
    elif case == "c30":
        x, wt = (torch.empty((2, 8, 8, 30), device=dev),
                 torch.empty((30, 1, 3, 3), device=dev))
    elif case == "2_31_elements":
        x = torch.empty((1, 2 ** 14, 2 ** 15, 4), device=dev)
        wt = torch.empty((4, 1, 3, 3), device=dev)
    elif case == "multiplier_2":
        wt = torch.empty((32, 1, 3, 3), device=dev)
    elif case == "two_inputs_a_group":
        wt = torch.empty((16, 2, 3, 3), device=dev)
    elif case == "k4":
        wt = torch.empty((16, 1, 4, 4), device=dev)
    elif case == "k3x5":
        wt = torch.empty((16, 1, 3, 5), device=dev)
    elif case == "stride3":
        stride = 3
    elif case == "pad_of_k":
        pads = (3, 3, 3, 3)
    elif case == "bias_of_c2":
        b = torch.empty(32, device=dev)
    elif case == "no_output":
        x = torch.empty((2, 2, 2, 16), device=dev)
        wt, pads = torch.empty((16, 1, 5, 5), device=dev), (0, 0, 0, 0)
    elif case == "weight_on_cpu":
        wt = torch.empty((16, 1, 3, 3))
    elif case == "bn_float64":
        bn[1] = bn[1].double()
    elif case == "bn_of_c2":
        bn[2] = torch.empty(32, device=dev)
    elif case == "bn_strided":
        bn[3] = torch.empty(32, device=dev)[::2]
    elif case == "bn_on_cpu":
        bn[0] = torch.zeros(16)
    elif case == "act_without_bn":
        bn = None
    elif case == "act_swish":
        act = "swish"
    elif case == "bn_requires_grad":
        bn[2] = bn[2].requires_grad_(True)
    else:
        x = x.requires_grad_(True)
    return x, wt, b, stride, pads, bn, act


@pytest.mark.parametrize("case,error", REFUSED,
                         ids=[case for case, _ in REFUSED])
def test_dwconv_refuses_what_the_kernel_does_not_take(case, error):
    before = _build.launches("dwconv")
    with pytest.raises(error):
        dw.dwconv(*_refused_case(case))
    assert _build.launches("dwconv") == before


@pytest.mark.parametrize("name,calls", [("MobileNetV2", 17),
                                        ("ResNet50", 0)])
def test_a_forward_calls_the_kernel_once_a_depthwise_conv(monkeypatch, name,
                                                          calls):
    net = cnn.REAL_CNNS[name]()
    params = net.init(CPU, torch.Generator().manual_seed(0))
    x = torch.randn((1,) + net.input_shape,
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        expect = net.apply(params, x)
        seen, fused = [], []

        def counted(*args):
            seen.append(args[3:5])
            fused.append(args[5] is not None and args[6] == "relu6")
            return dw.dwconv(*args)

        monkeypatch.setattr(layers, "dwconv", counted)
        got = net.apply(params, x)
    assert len(seen) == calls
    assert seen == [(s, p) for *_, s, p in _depthwise_convs([name])]
    assert all(fused)       # each with the BN and ReLU6 in its epilogue
    assert torch.equal(got, expect)


def _one_conv(groups, filters=8):
    """A network of one grouped 3x3 stride-2 conv over (9, 9, 8)."""
    b = layers.Builder("one", (9, 9), channels=8)
    b.conv(layers.GraphModel.INPUT, filters, 3, stride=2, groups=groups)
    return b.build()


@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_autograd_runs_the_plain_ops(monkeypatch, dev):
    """With an input that requires grad the depthwise step runs
    ``dwconv_ref`` (the kernel has no backward): no kernel call, no cost
    reported, and a gradient on the CPU."""
    net = _one_conv(groups=8)
    params = net.init(CPU, torch.Generator().manual_seed(0))
    params = {n: {k: t.to(dev) for k, t in p.items()} for n, p in
              params.items()}
    monkeypatch.setattr(layers, "dwconv", None)     # a call would fail
    x = torch.randn((2, 9, 9, 8)).to(dev).requires_grad_(True)
    costs = []
    with _build.cost_sink(lambda *a: costs.append(a)):
        y = net.apply(params, x)
    assert y.shape == (2, 5, 5, 8) and costs == []
    if dev == "cpu":
        y.sum().backward()
        assert x.grad is not None and x.grad.shape == x.shape


def test_a_grouped_conv_that_is_not_depthwise_keeps_the_pad_and_conv():
    """groups 2 over 8 channels: the ``F.pad`` + ``conv2d`` route inside
    the span, chosen when the node is built; the kernel is not called."""
    net = _one_conv(groups=2)
    params = net.init(CPU, torch.Generator().manual_seed(0))
    p = params[net.output]
    x = torch.randn((2, 9, 9, 8))
    expect = layers._nhwc(F.conv2d(F.pad(layers._nchw(x), _same(9, 9, 3, 2)),
                                   p["w"], p["b"], stride=2, groups=2))
    with mock.patch.object(layers, "dwconv", None), \
            mock.patch.object(layers, "span", wraps=layers.span) as opened:
        assert torch.equal(net.apply(params, x), expect)
    opened.assert_called_once_with(layers.DWCONV_SPAN)


def test_a_depthwise_conv_adds_its_bias():
    net = _one_conv(groups=8)
    params = net.init(CPU, torch.Generator().manual_seed(0))
    p = params[net.output]
    p["b"] = torch.arange(8.0)
    x = torch.randn((2, 9, 9, 8))
    with torch.no_grad():
        y = net.apply(params, x)
    pads = _same(9, 9, 3, 2)
    assert torch.equal(y, _route_before(x, p["w"], p["b"], 2, pads))
    assert not torch.equal(y, _route_before(x, p["w"], None, 2, pads))


# -- the card -----------------------------------------------------------------
@pytest.fixture
def sm90():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernel is built for sm_90a")
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        yield torch.device("cuda")


def _kernel_close(x, wt, b, stride, pads):
    """One counted launch, within ULPS of the plain ops' scale."""
    before = _build.launches("dwconv")
    with torch.no_grad():
        got = dw.dwconv(x, wt, b, stride, pads)
        expect = dwconv_ref(x, wt, b, stride, pads)
    torch.cuda.synchronize()
    assert _build.launches("dwconv") == before + 1
    assert got.shape == expect.shape and got.is_contiguous()
    scale = expect.abs().max().item()
    err = (got - expect).abs().max().item()
    assert err <= ULPS * torch.finfo(torch.float32).eps * scale, (err, scale)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", MOBILENETV2,
                         ids=[f"dw{i}-" + i_d for i, i_d in
                              enumerate(_ids(MOBILENETV2))])
def test_kernel_at_mobilenetv2s_convs(sm90, case):
    h, w, c, k, stride, pads = case
    x, wt, _ = _inputs(sm90, 256, h, w, c, k)
    _kernel_close(x, wt, None, stride, pads)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ODD, ids=_ids(ODD))
def test_kernel_at_k5_k7_and_odd_sizes(sm90, case):
    h, w, c, k, stride = case
    x, wt, b = _inputs(sm90, 8, h, w, c, k, bias=True)
    _kernel_close(x, wt, None, stride, _same(h, w, k, stride))
    _kernel_close(x, wt, b, stride, _same(h, w, k, stride))
    if h >= k and w >= k:           # no padding
        _kernel_close(x, wt, None, stride, (0, 0, 0, 0))


@pytest.mark.cuda
def test_kernel_takes_the_weight_as_a_view_of_a_flat_buffer(sm90):
    """A stage's weights are views into one flat vector (the SPMD tier),
    4 bytes off 16 here: the kernel reads the taps one float at a time."""
    x, wt, _ = _inputs(sm90, 4, 14, 14, 576, 3)
    flat = torch.empty(1 + wt.numel(), device=sm90)
    flat[1:] = wt.reshape(-1)
    view = flat[1:].view(576, 1, 3, 3)
    assert view.data_ptr() % 16
    got = _kernel_close(x, view, None, 1, (1, 1, 1, 1))
    assert torch.equal(got, dw.dwconv(x, wt, None, 1, (1, 1, 1, 1)))


@pytest.mark.cuda
def test_kernel_refuses_2_31_elements_and_bad_arguments_before_a_launch(
        sm90):
    """The C entry returns cudaErrorInvalidValue (1) before any launch: the
    pointers are null."""
    fn, raw_stream = dw._kernel()
    dev = torch.cuda.current_device()

    def call(n=1, h=8, w=8, c=16, oh=8, ow=8, k=3, s=1, pt=1, pl=1,
             bn=(None,) * 4, act=0):
        return fn(None, None, None, None, *bn, act, n, h, w, c, oh, ow, k,
                  s, pt, pl, dev, raw_stream(dev))

    assert call(n=2 ** 15, h=2 ** 8, w=2 ** 8, c=4 * 2 ** 3) == 1
    assert call(oh=2 ** 14, ow=2 ** 14, c=8) == 1
    assert call(c=30) == call(k=4) == call(s=3) == call(pt=3) == 1
    assert call(pl=-1) == call(oh=0) == 1
    # the epilogue: all four per-channel pointers or none (never read
    # here), an activation code of 0 to 2, and none without the BN
    assert call(bn=(16, None, None, None)) == call(bn=(16, 16, 16, None)) == 1
    assert call(bn=(16,) * 4, act=3) == call(bn=(16,) * 4, act=-1) == 1
    assert call(act=1) == call(act=2) == 1


# (case, the error) on the card, beside the meta cases above
REFUSED_ON_CARD = [("offset_view", ValueError), ("transposed", ValueError),
                   ("requires_grad", RuntimeError),
                   ("bn_on_cpu", ValueError), ("bn_strided", ValueError),
                   ("bn_float64", TypeError), ("act_without_bn", ValueError),
                   ("bn_requires_grad", RuntimeError)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,error", REFUSED_ON_CARD,
                         ids=[case for case, _ in REFUSED_ON_CARD])
def test_kernel_refuses_on_the_card(sm90, case, error):
    x, wt, _ = _inputs(sm90, 2, 8, 8, 16, 3)
    bn, act = list(_bn(sm90, 16)), "relu6"
    if case == "offset_view":           # 4 bytes off 16
        x = torch.empty(1 + x.numel(), device=sm90)[1:].view(x.shape)
    elif case == "transposed":
        x = x.transpose(1, 2)
    elif case == "requires_grad":
        x = x.requires_grad_(True)
    elif case == "bn_on_cpu":
        bn[0] = bn[0].cpu()
    elif case == "bn_strided":
        bn[1] = torch.ones(32, device=sm90)[::2]
    elif case == "bn_float64":
        bn[2] = bn[2].double()
    elif case == "act_without_bn":
        bn = None
    else:
        bn[3] = bn[3].requires_grad_(True)
    before = _build.launches("dwconv"), _build.launches("dwconv.bn")
    with pytest.raises(error):
        dw.dwconv(x, wt, None, 1, (1, 1, 1, 1), bn, act)
    assert (_build.launches("dwconv"), _build.launches("dwconv.bn")) == before


@pytest.mark.cuda
def test_kernel_launches_on_the_current_stream(sm90):
    """On a side stream, after the card has slept there: the kernel reads x
    only once that stream has written it."""
    x0, wt, _ = _inputs(sm90, 64, 56, 56, 144, 3)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.no_grad(), torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        x = x0 * 1
        got = dw.dwconv(x, wt, None, 2, (0, 1, 0, 1))
    torch.cuda.synchronize()
    assert torch.equal(got, dw.dwconv(x0, wt, None, 2, (0, 1, 0, 1)))


@pytest.mark.cuda
def test_kernel_on_a_second_card(sm90):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    dev = torch.device("cuda", 1)
    x, wt, _ = _inputs(dev, 4, 28, 28, 192, 3)
    torch.cuda.set_device(0)
    with torch.no_grad():
        got = dw.dwconv(x, wt, None, 1, (1, 1, 1, 1))
    assert torch.cuda.current_device() == 0 and got.device == dev
    assert _build.launches_by_card("dwconv").get(1, 0) >= 1


def _fused_equal(x, wt, b, stride, pads, ps, act):
    """One counted launch with the epilogue, equal bit for bit to
    ``dwconv`` then ``bn_epilogue`` (NaNs where they are); the output."""
    before = _build.launches("dwconv"), _build.launches("dwconv.bn")
    with torch.no_grad():
        got = dw.dwconv(x, wt, b, stride, pads, ps, act)
        torch.cuda.synchronize()
        assert (_build.launches("dwconv"), _build.launches("dwconv.bn")) == (
            before[0] + 1, before[1] + 1)
        expect = be.bn_epilogue(dw.dwconv(x, wt, b, stride, pads), *ps,
                                None, act)
    torch.cuda.synchronize()
    assert got.shape == expect.shape and got.is_contiguous()
    nan = expect.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got[~nan], expect[~nan]), (
        (got - expect)[~nan].abs().max().item())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", MOBILENETV2,
                         ids=[f"dw{i}-" + i_d for i, i_d in
                              enumerate(_ids(MOBILENETV2))])
def test_fused_launch_at_mobilenetv2s_convs(sm90, case):
    h, w, c, k, stride, pads = case
    x, wt, _ = _inputs(sm90, 256, h, w, c, k)
    y = _fused_equal(x, wt, None, stride, pads, _bn(sm90, c), "relu6")
    assert 0 < (y == 6).sum().item() < y.numel()     # the ceiling is hit


@pytest.mark.cuda
@pytest.mark.parametrize("act", [None, "relu", "relu6"])
@pytest.mark.parametrize("case", ODD, ids=_ids(ODD))
def test_fused_launch_at_k5_k7_and_odd_sizes(sm90, case, act):
    h, w, c, k, stride = case
    x, wt, b = _inputs(sm90, 8, h, w, c, k, bias=True)
    ps = _bn(sm90, c)
    _fused_equal(x, wt, None, stride, _same(h, w, k, stride), ps, act)
    _fused_equal(x, wt, b, stride, _same(h, w, k, stride), ps, act)


@pytest.mark.cuda
@pytest.mark.parametrize("act", [None, "relu", "relu6"])
def test_fused_launch_passes_a_nan_and_clips_at_six(sm90, act):
    """A NaN in x reaches every output whose window holds it, through the
    BN and the activation, as ``bn_epilogue`` gives it; finite outputs
    past 6 are 6 under ReLU6."""
    x, wt, _ = _inputs(sm90, 4, 14, 14, 64, 3)
    x = x * 8
    x[1, 3, 5, 7] = float("nan")
    x[2, 0, 0, :] = float("nan")
    y = _fused_equal(x, wt, None, 1, (1, 1, 1, 1), _bn(sm90, 64), act)
    assert y.isnan().sum().item() >= 9 + 4 * 64
    finite = y[~y.isnan()]
    if act == "relu6":
        assert finite.max().item() == 6 and finite.min().item() == 0
    elif act is None:
        assert finite.max().item() > 6 and finite.min().item() < 0


def _mobilenetv2(dev, n):
    net = cnn.REAL_CNNS["MobileNetV2"]()
    params = net.init(dev, torch.Generator(dev).manual_seed(0))
    x = torch.randn((n,) + net.input_shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(1))
    return net, params, x


@pytest.mark.cuda
def test_mobilenetv2_forward_is_17_dwconv_launches(sm90):
    """Each with its BN and ReLU6 in the epilogue: 35 ``bn_epilogue``
    launches are left of the 52 BNs."""
    net, params, x = _mobilenetv2(sm90, 2)
    with torch.no_grad():
        _build.reset_launches()
        y = net.apply(params, x)
        torch.cuda.synchronize()
        assert _build.launches("dwconv") == 17
        assert _build.launches("dwconv.bn") / _build.launches("dwconv") == 1
        assert _build.launches("bn_epilogue") == 35
        with mock.patch.object(layers, "dwconv", dwconv_ref):
            plain = net.apply(params, x)
    assert _build.launches("dwconv") == 17
    scale = plain.abs().max().item()
    assert (y - plain).abs().max().item() <= SPMD_TOL * scale


@pytest.mark.cuda
def test_mobilenetv2_spmd_forward_matches_the_plain_route(sm90):
    """Four stages on four streams of the card, 4 microbatches of 4: 68
    launches, and the outputs within the cell's 1.5e-5 of max |y| of the
    direct forward through ``F.pad`` and cuDNN's grouped route."""
    net, params, x = _mobilenetv2(sm90, 16)
    with torch.no_grad(), mock.patch.object(layers, "dwconv", dwconv_ref):
        plain = net.apply(params, x)
    plan = api.plan(api.DeploymentSpec(stages=4, strategy="balanced"),
                    graph=net.to_layer_graph())
    with spmd.SpmdPipelineExecutor.for_cnn(
            net, params, plan, mesh=spmd.default_stage_mesh(4, sm90),
            n_microbatches=4, batch_size=16) as ex:
        _build.reset_launches()
        with torch.no_grad():
            y = ex(x)
        torch.cuda.synchronize()
    assert _build.launches("dwconv") == _build.launches("dwconv.bn") == 68
    err = (y - plain).abs().max().item() / plain.abs().max().item()
    assert err <= SPMD_TOL, err
    assert math.isfinite(err)
