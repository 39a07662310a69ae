"""The CNN forward's fused BN epilogue on the CPU: the groups that
``GraphModel.program`` forms, and the fused route against the unfused one.

* ResNet50's 53 BNs form 53 groups: 33 ``bn+relu``, 16 ``bn+add+relu`` and
  4 lone ``bn`` (the ``c_bn`` of the 4 projection blocks, whose add the
  shortcut's BN takes: it comes first in the order).
* A stage cut inside a group splits it: the boundary tensor is the
  unfused node's value.
* A group without an add takes in the depthwise conv its BN reads, under
  the same rules: MobileNetV2's 17, never Xception's or NASNetMobile's
  (theirs feed a pointwise conv), and ResNet50's programs stay step for
  step what they were before the depthwise fold.
* ``apply`` and ``apply_subset`` equal the nodes run one by one bit for bit
  (on the CPU both run the same plain ops).
* While autograd records, a group runs the plain ops (the kernel has no
  backward).
* ``bn_epilogue``'s CPU route is the plain ops; its ``meta`` route returns
  the output's shape and reports its cost, and refuses what the kernel
  would refuse on the card (dtype, layout, sizes, a gradient).

The kernel itself is held against the plain ops on the card
(``tests/test_torch_cuda.py``).
"""
import collections
import hashlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import DeploymentSpec, plan
from repro_torch.kernels import _build
from repro_torch.kernels import bn_epilogue as be
from repro_torch.kernels.ref import bn_epilogue_ref
from repro_torch.launch.pipeline_spmd import cnn_boundary_specs
from repro_torch.models import cnn
from repro_torch.models.layers import Builder, GraphModel

CPU = torch.device("cpu")


def _unfused(m, params, x):
    """Every node's activation, the nodes run one by one."""
    acts = {GraphModel.INPUT: x}
    for name in m._order:
        node = m.nodes[name]
        acts[name] = node.apply(params.get(name, {}),
                                [acts[i] for i in node.inputs])
    return acts


def _random_params(m, seed=0):
    """Weights from ``init`` with BN statistics and affine values drawn at
    random (``init``'s are 0 and 1, which would hide an operand mix-up)."""
    g = torch.Generator(CPU).manual_seed(seed)
    params = m.init(CPU, g)
    for name, node in m.nodes.items():
        if node.kind == "bn":
            c = node.out_shape[-1]
            params[name] = {
                "gamma": torch.rand(c, generator=g) + 0.5,
                "beta": torch.randn(c, generator=g),
                "mean": torch.randn(c, generator=g) * 0.1,
                "var": torch.rand(c, generator=g) + 0.5}
    return params


def _kinds(groups):
    return collections.Counter(
        "+".join((["dw"] if g.conv else []) + ["bn"]
                 + (["add"] if g.add else []) + ([g.fn] if g.fn else []))
        for g in groups)


def _cell_programs(name):
    """The model, and its programs over the front door's balanced 4-stage
    plan with the SPMD tier's boundaries."""
    m = cnn.REAL_CNNS[name]()
    pl = plan(DeploymentSpec(model=f"cnn:{name}", stages=4,
                             strategy="balanced"), graph=m.to_layer_graph())
    specs, _ = cnn_boundary_specs(m, pl)
    return m, pl, [m.program(layers, [n for n, _ in specs[s]])
                   for s, layers in enumerate(pl.stage_layers)]


def test_resnet50_groups():
    m = cnn.REAL_CNNS["ResNet50"]()
    groups = m.program().groups
    assert len(groups) == sum(n.kind == "bn" for n in m.nodes.values()) == 53
    assert _kinds(groups) == {"bn+relu": 33, "bn+add+relu": 16, "bn": 4}
    lone = sorted(g.bn for g in groups if g.out == g.bn)
    assert lone == ["s0b0_c_bn", "s1b0_c_bn", "s2b0_c_bn", "s3b0_c_bn"]


@pytest.mark.parametrize("block", ["s0b0", "s1b0", "s2b0", "s3b0"])
def test_add_fed_by_two_bns_is_taken_by_one_group(block):
    m = cnn.REAL_CNNS["ResNet50"]()
    add = f"{block}_add"
    assert sorted(m.nodes[add].inputs) == [f"{block}_c_bn", f"{block}_scbn"]
    groups = m.program().groups
    takers = [g for g in groups if g.add == add]
    assert len(takers) == 1
    (g,) = takers
    assert g.nodes == (g.bn, add, f"{block}_out") and g.fn == "relu"
    other = ({f"{block}_c_bn", f"{block}_scbn"} - {g.bn}).pop()
    assert g.residual == other
    assert [h.nodes for h in groups if h.bn == other] == [(other,)]
    # the group runs at its last node's place, after the other BN
    outs = [step[0] for step in m.program().steps]
    assert outs.index(other) < outs.index(g.out)


def _tiny_residual():
    """conv-bn-relu, then a block whose shortcut bn and main bn feed one
    add and a relu, then a bn with swish and one with sigmoid."""
    b = Builder("tiny", (6, 6), 4)
    x = b.conv(b.model.INPUT, 8, 3, use_bias=False, name="c0")
    x = b.act(b.bn(x, "bn0"), "relu", "r0")
    sc = b.bn(b.conv(x, 8, 1, use_bias=False, name="sc"), "scbn")
    y = b.bn(b.conv(x, 8, 3, use_bias=False, name="c1"), "bn1")
    x = b.act(b.add([sc, y], "add"), "relu", "out")
    x = b.act(b.bn(b.conv(x, 8, 1, name="c2"), "bn2"), "swish", "sw")
    x = b.act(b.bn(b.conv(x, 8, 1, name="c3"), "bn3"), "sigmoid", "sg")
    b.dense(b.gap(x, "gap"), 5, name="head")
    return b.build()


def test_swish_and_sigmoid_stay_on_the_plain_route():
    m = _tiny_residual()
    groups = {g.bn: g for g in m.program().groups}
    assert groups["bn2"].nodes == ("bn2",) and groups["bn3"].nodes == (
        "bn3",)
    assert groups["scbn"].nodes == ("scbn", "add", "out")
    assert groups["bn1"].nodes == ("bn1",)
    assert groups["bn0"].nodes == ("bn0", "r0")
    plain = {step[0] for step in m.program().steps}
    assert {"sw", "sg"} <= plain


# (cut after this node, the group it splits, the boundary tensors)
CUTS = [("bn0", "bn0+relu", {"bn0"}),
        ("bn1", "scbn+add+relu", {"scbn", "bn1"}),
        ("add", "scbn+add+relu", {"add"})]


@pytest.mark.parametrize("after,split,crossing", CUTS,
                         ids=["bn|relu", "bn|add", "add|relu"])
def test_a_cut_inside_a_group_splits_it(after, split, crossing):
    m = _tiny_residual()
    params = _random_params(m)
    x = torch.randn(2, 6, 6, 4, generator=torch.Generator().manual_seed(1))
    order = m._order
    first, second = (order[:order.index(after) + 1],
                     order[order.index(after) + 1:])
    p1 = m.program(first)
    assert crossing <= set(p1.returns)
    whole = {g.bn: g.nodes for g in m.program().groups}
    cut = {g.bn: g.nodes for g in p1.groups}
    assert any(cut[bn] != nodes for bn, nodes in whole.items() if bn in cut)
    boundary = m.apply_subset(params, {m.INPUT: x}, first)
    expect = _unfused(m, params, x)
    for name in crossing:
        assert torch.equal(boundary[name], expect[name]), name
    out = m.apply_subset(params, boundary, second)
    assert torch.equal(out[m.output], expect[m.output])


@pytest.mark.parametrize("name", ["ResNet50", "ResNet50V2", "MobileNetV2",
                                  "EfficientNetLiteB0", "MobileNet"])
def test_fused_route_equals_unfused_bit_for_bit(name):
    """``apply``, and ``apply_subset`` over the front door's balanced
    4-stage plan with the SPMD tier's boundaries, against the nodes run one
    by one."""
    m = cnn.REAL_CNNS[name]()
    params = _random_params(m)
    x = torch.randn((1,) + m.input_shape,
                    generator=torch.Generator().manual_seed(2))
    expect = _unfused(m, params, x)
    assert torch.equal(m.apply(params, x), expect[m.output])
    pl = plan(DeploymentSpec(model=f"cnn:{name}", stages=4,
                             strategy="balanced"), graph=m.to_layer_graph())
    specs, _ = cnn_boundary_specs(m, pl)
    acts = {m.INPUT: x}
    for s, layers in enumerate(pl.stage_layers):
        boundary = {n: acts[n] for n, _ in specs[s]}
        out = m.apply_subset(params, boundary, layers)
        for n, t in out.items():
            assert torch.equal(t, expect[n]), (s, n)
        acts.update(out)
    assert torch.equal(acts[m.output], expect[m.output])


def test_resnet50_cell_plan_splits_one_group():
    """The benchmark's 4-stage balanced plan cuts between ``s2b4_a_bn`` and
    its ReLU: 53 epilogue calls and one plain ReLU a microbatch.  (The cut
    between ``s3b0_scbn`` and its add moves the add to the block's other
    BN, which costs nothing.)"""
    m = cnn.REAL_CNNS["ResNet50"]()
    pl = plan(DeploymentSpec(model="cnn:ResNet50", stages=4,
                             strategy="balanced"), graph=m.to_layer_graph())
    specs, _ = cnn_boundary_specs(m, pl)
    progs = [m.program(layers, [n for n, _ in specs[s]])
             for s, layers in enumerate(pl.stage_layers)]
    groups = [g for p in progs for g in p.groups]
    assert len(groups) == 53
    assert _kinds(groups) == {"bn+relu": 32, "bn+add+relu": 16, "bn": 5}
    outs = {g.out for g in groups}
    plain = [step[0] for p in progs for step in p.steps
             if step[0] not in outs and m.nodes[step[0]].kind in ("add",
                                                                  "act")]
    assert plain == ["s2b4_a_relu"]


# the (output, inputs, params' nodes) of every step of ResNet50's whole
# program and of its four stage programs at the benchmark's plan, as they
# were before groups took depthwise convs in: a sha256 of their repr
RESNET50_STEPS = (
    "2972471a4fe17cf8e45c40bbdbbc226fad687357a0b2dab5c91b31dda08b8950")


def test_resnet50_programs_are_step_for_step_the_same():
    """ResNet50 has no depthwise conv: its programs, their steps, groups
    and owners are what they were before groups took convs in."""
    m, _, progs = _cell_programs("ResNet50")
    progs = [m.program()] + progs
    rows = [[(out, inputs, owners) for out, _, inputs, owners in p.steps]
            for p in progs]
    assert [len(r) for r in rows] == [109, 77, 16, 8, 9]
    assert hashlib.sha256(repr(rows).encode()).hexdigest() == RESNET50_STEPS
    assert not any(g.conv for p in progs for g in p.groups)


def test_mobilenetv2_groups_take_in_the_17_depthwise_convs():
    m = cnn.REAL_CNNS["MobileNetV2"]()
    groups = m.program().groups
    dw = [n for n, node in m.nodes.items() if node.depthwise is not None]
    assert len(dw) == 17
    assert _kinds(groups) == {"dw+bn+relu6": 17, "bn+relu6": 18, "bn": 7,
                              "bn+add": 10}
    for g in groups:
        if g.conv:
            assert g.nodes == (g.conv, g.bn, g.act)
            assert m.nodes[g.bn].inputs == [g.conv]
    assert sorted(g.conv for g in groups if g.conv) == sorted(dw)
    # a step a group: the conv's input in, both nodes' params
    steps = {step[0]: step for step in m.program().steps}
    for g in groups:
        if g.conv:
            _, _, inputs, owners = steps[g.out]
            assert inputs == tuple(m.nodes[g.conv].inputs)
            assert owners == (g.conv, g.bn)
    assert not set(dw) & set(steps)


def test_mobilenetv2_cell_plan_keeps_ir14s_group_whole():
    """The benchmark's balanced cuts [125, 126, 147] make ``ir14_proj``
    stage 1 alone: ``ir14_dw``, ``bn_73`` and ``relu6_74`` end stage 0, so
    all 17 groups take conv, BN and ReLU6 in.  A cut after ``bn_73``
    leaves ``(ir14_dw, bn_73)``, and ``relu6_74`` runs as a plain step of
    the next stage."""
    m, pl, progs = _cell_programs("MobileNetV2")
    assert [len(layers) for layers in pl.stage_layers] == [126, 1, 21, 3]
    assert pl.stage_layers[0][-1] == "relu6_74"
    assert pl.stage_layers[1] == ["ir14_proj"]
    groups = [g for p in progs for g in p.groups]
    assert _kinds(g for g in groups if g.conv) == {"dw+bn+relu6": 17}
    (ir14,) = [g for g in progs[0].groups if g.conv == "ir14_dw"]
    assert ir14.nodes == ("ir14_dw", "bn_73", "relu6_74")
    order = m._order
    cut = order.index("bn_73") + 1
    first, second = m.program(order[:cut]), m.program(order[cut:], ["bn_73"])
    (ir14,) = [g for g in first.groups if g.conv == "ir14_dw"]
    assert ir14.nodes == ("ir14_dw", "bn_73") and "bn_73" in first.returns
    assert second.steps[0][0] == "relu6_74"
    assert "relu6_74" not in {n for g in second.groups for n in g.nodes}


@pytest.mark.parametrize("name,convs", [("Xception", 34),
                                        ("NASNetMobile", 128)])
def test_depthwise_convs_that_feed_a_pointwise_conv_stay_alone(name, convs):
    m = cnn.REAL_CNNS[name]()
    dw = [n for n, node in m.nodes.items() if node.depthwise is not None]
    assert len(dw) == convs
    progs = [m.program()] + _cell_programs(name)[2]
    assert not any(g.conv for p in progs for g in p.groups)
    plain = {step[0] for step in progs[0].steps}
    assert set(dw) <= plain


def _tiny_inverted_residual():
    """A MobileNetV2 block: expand, depthwise, project, each with its BN
    (ReLU6 after the first two); then a depthwise conv read by its BN and
    by a concat, which no group may take in."""
    b = Builder("tiny_ir", (7, 7), 8)
    x = b.act(b.bn(b.conv(b.model.INPUT, 16, 1, use_bias=False, name="ex"),
                   "exbn"), "relu6", "exr")
    x = b.act(b.bn(b.dwconv(x, 3, 2, use_bias=False, name="dw"), "dwbn"),
              "relu6", "dwr")
    x = b.bn(b.conv(x, 8, 1, use_bias=False, name="pr"), "prbn")
    y = b.dwconv(x, 3, name="dw2")
    x = b.concat([b.bn(y, "dw2bn"), y], "cat")
    b.dense(b.gap(x, "gap"), 5, name="head")
    return b.build()


def test_a_depthwise_conv_read_twice_stays_alone():
    m = _tiny_inverted_residual()
    groups = {g.bn: g for g in m.program().groups}
    assert groups["dwbn"].nodes == ("dw", "dwbn", "dwr")
    assert groups["dw2bn"].nodes == ("dw2bn",)
    params = _random_params(m)
    x = torch.randn(2, 7, 7, 8, generator=torch.Generator().manual_seed(6))
    assert torch.equal(m.apply(params, x), _unfused(m, params, x)[m.output])


# (cut after this node, the first stage's group of dwbn, the second's)
DW_CUTS = [("dw", None, ("dwbn", "dwr")),
           ("dwbn", ("dw", "dwbn"), None),
           ("dwr", ("dw", "dwbn", "dwr"), None)]


@pytest.mark.parametrize("after,first_group,second_group", DW_CUTS,
                         ids=["dw|bn", "bn|relu6", "relu6|pr"])
def test_a_cut_after_a_depthwise_conv_leaves_it_out(after, first_group,
                                                    second_group):
    """A cut right after the conv hands its unfused output over and the
    group of the next stage is its BN and ReLU6; a cut after the BN keeps
    the conv and the BN together."""
    m = _tiny_inverted_residual()
    params = _random_params(m)
    x = torch.randn(2, 7, 7, 8, generator=torch.Generator().manual_seed(7))
    order = m._order
    first, second = (order[:order.index(after) + 1],
                     order[order.index(after) + 1:])
    p1, p2 = m.program(first), m.program(second, [after])
    for prog, want in ((p1, first_group), (p2, second_group)):
        got = [g.nodes for g in prog.groups if "dwbn" in g.nodes]
        assert got == ([want] if want else [])
    assert after in p1.returns
    expect = _unfused(m, params, x)
    boundary = m.apply_subset(params, {m.INPUT: x}, first)
    assert torch.equal(boundary[after], expect[after])
    out = m.apply_subset(params, boundary, second)
    assert torch.equal(out[m.output], expect[m.output])


def test_a_depthwise_group_under_autograd_runs_the_plain_ops():
    """While autograd records through the input or a BN parameter, the
    conv's group runs ``dwconv_ref``'s ops: on ``meta`` no cost is
    reported; under no_grad one ``dwconv`` call with the epilogue's cost.
    On the CPU the gradients equal those of the nodes run one by one."""
    b = Builder("dw_first", (6, 6), 8)
    b.act(b.bn(b.dwconv(b.model.INPUT, 3, use_bias=False, name="dw"),
               "bn"), "relu6", "r")
    m = b.build()
    assert [g.nodes for g in m.program().groups] == [("dw", "bn", "r")]
    params = _random_params(m)
    meta = {k: {n: t.to("meta") for n, t in p.items()}
            for k, p in params.items()}
    x = torch.empty((2, 6, 6, 8), device="meta")
    for inp, ps in ((x.requires_grad_(True), meta),
                    (x.detach(), {**meta, "bn": {**meta["bn"], "beta": meta[
                        "bn"]["beta"].requires_grad_(True)}})):
        seen = []
        with _build.cost_sink(lambda *a: seen.append(a)):
            y = m.apply(ps, inp)
        assert y.grad_fn is not None and seen == []
        with torch.no_grad(), _build.cost_sink(lambda *a: seen.append(a)):
            m.apply(ps, inp)
        n = 2 * 6 * 6 * 8
        assert seen == [("dwconv", 23 * n, 4 * (2 * n + 72 + 32))]
    xc = torch.randn(2, 6, 6, 8, generator=torch.Generator().manual_seed(8))
    grads = []
    for run in (lambda v: m.apply(params, v),
                lambda v: _unfused(m, params, v)[m.output]):
        v = xc.clone().requires_grad_(True)
        run(v).square().sum().backward()
        grads.append(v.grad)
    assert torch.equal(grads[0], grads[1])


def test_program_is_built_once_per_subset_and_boundary():
    m = _tiny_residual()
    assert m.program() is m.program()
    first = m._order[:4]
    assert m.program(first) is m.program(list(first))
    assert m.program(first, ["a"]) is not m.program(first, ["b"])


def _bn_inputs(shape, residual, dtype=torch.float32, device=CPU):
    g = torch.Generator().manual_seed(3)
    c = shape[-1]
    x = torch.randn(shape, generator=g).to(device, dtype)
    r = torch.randn(shape, generator=g).to(device, dtype) if residual else None
    ps = [torch.randn(c, generator=g) * 0.1, torch.rand(c, generator=g) + .5,
          torch.rand(c, generator=g) + .5, torch.randn(c, generator=g)]
    return x, r, [p.to(device) for p in ps]


@pytest.mark.parametrize("act", [None, "relu", "relu6"])
@pytest.mark.parametrize("residual", [False, True])
def test_cpu_route_is_the_plain_ops(act, residual):
    x, r, (mean, var, gamma, beta) = _bn_inputs((2, 3, 3, 12), residual)
    y = be.bn_epilogue(x, mean, var, gamma, beta, r, act)
    inv = torch.rsqrt(var + 1e-3)
    expect = (x - mean) * inv * gamma + beta
    if residual:
        expect = r + expect
    expect = {None: expect, "relu": torch.relu(expect),
              "relu6": torch.clamp(expect, 0, 6)}[act]
    assert torch.equal(y, expect)
    assert torch.equal(y, bn_epilogue_ref(x, mean, var, gamma, beta, r, act))


def test_autograd_runs_the_plain_ops():
    """While autograd records through an input or a parameter, a group runs
    the plain ops: on ``meta`` no cost is reported (the kernel's route
    would report one) and the output records its graph; under no_grad the
    same model reports one call.  On the CPU the gradients equal those of
    the nodes run one by one."""
    b = Builder("bn_first", (5, 5), 8)
    b.act(b.add([b.bn(b.model.INPUT, "bn"), b.model.INPUT], "add"), "relu",
          "r")
    m = b.build()
    assert [g.nodes for g in m.program().groups] == [("bn", "add", "r")]
    params = _random_params(m)
    meta = {k: {n: t.to("meta") for n, t in p.items()}
            for k, p in params.items()}
    x = torch.empty((2, 5, 5, 8), device="meta")
    for inp, ps in ((x.requires_grad_(True), meta),
                    (x.detach(), {"bn": {**meta["bn"], "gamma": meta["bn"][
                        "gamma"].requires_grad_(True)}})):
        seen = []
        with _build.cost_sink(lambda *a: seen.append(a)):
            y = m.apply(ps, inp)
        assert y.grad_fn is not None and seen == []
        with torch.no_grad(), _build.cost_sink(lambda *a: seen.append(a)):
            m.apply(ps, inp)
        assert [a[0] for a in seen] == ["bn_epilogue"]
    xc = torch.randn(2, 5, 5, 8, generator=torch.Generator().manual_seed(5))
    grads = []
    for run in (lambda v: m.apply(params, v),
                lambda v: _unfused(m, params, v)[m.output]):
        v = xc.clone().requires_grad_(True)
        run(v).square().sum().backward()
        grads.append(v.grad)
    assert torch.equal(grads[0], grads[1])


def test_bn_epilogue_refuses_a_gradient_off_the_cpu():
    """The kernel has no backward: on ``meta`` (the card's route up to the
    launch) an input that requires grad while autograd records raises;
    under no_grad the same call reports its cost."""
    x, r, ps = _bn_inputs((2, 3, 3, 8), True, device="meta")
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        be.bn_epilogue(x, *ps, r, "relu")
    seen = []
    with torch.no_grad(), _build.cost_sink(lambda *a: seen.append(a)):
        be.bn_epilogue(x, *ps, r, "relu")
    assert [a[0] for a in seen] == ["bn_epilogue"]


@pytest.mark.parametrize("residual", [False, True])
def test_meta_route_returns_the_shape_and_reports_its_cost(residual):
    x, r, ps = _bn_inputs((4, 5, 5, 16), residual, device="meta")
    seen = []
    _build.reset_launches()
    with _build.cost_sink(lambda *a: seen.append(a)):
        y = be.bn_epilogue(x, *ps, r, "relu")
    assert y.device.type == "meta" and y.shape == x.shape
    assert y.dtype == torch.float32
    n = x.numel()
    assert seen == [("bn_epilogue", (5 + residual) * n,
                     4 * n * (2 + residual) + 16 * 16)]
    assert _build.launches("bn_epilogue") == 0


def test_meta_forward_of_a_model_has_the_output_shape():
    """A model whose groups read contiguous tensors on ``meta`` (a BN of
    the input with its add and ReLU, a BN after a pool): one reported call
    a group, and the output's shape.  (``meta``'s convolution leaves NCHW
    strides where cuDNN's leaves NHWC ones, so a BN after a convolution
    is refused there.)"""
    b = Builder("bn_first", (6, 6), 8)
    x = b.act(b.add([b.bn(b.model.INPUT, "bn0"), b.model.INPUT], "add"),
              "relu", "r0")
    x = b.act(b.bn(b.pool(x, "max", 2, 2, name="pool"), "bn1"), "relu6",
              "r1")
    b.dense(b.gap(x, "gap"), 5, name="head")
    m = b.build()
    assert len(m.program().groups) == 2
    meta = torch.device("meta")
    params = {k: {n: t.to(meta) for n, t in p.items()}
              for k, p in _random_params(m).items()}
    seen = []
    with _build.cost_sink(lambda *a: seen.append(a)):
        y = m.apply(params, torch.empty((3, 6, 6, 8), device=meta))
    assert y.device.type == "meta" and tuple(y.shape) == (3, 5)
    assert [a[0] for a in seen].count("bn_epilogue") == 2


# (case, the error): what the kernel does not take raises off the CPU
REFUSED = [("transposed", ValueError), ("float64", TypeError),
           ("r_shape", ValueError), ("mean_size", ValueError),
           ("mean_float64", TypeError), ("r_float64", TypeError),
           ("mean_on_cpu", ValueError), ("2^31_elements", ValueError)]


@pytest.mark.parametrize("case,error", REFUSED,
                         ids=[case for case, _ in REFUSED])
def test_inputs_the_kernel_does_not_take_are_refused(case, error):
    """On ``meta`` tensors (the card's route up to the launch) these inputs
    raise, report no cost and fall back to nothing; the same inputs on the
    CPU run the plain ops."""
    shape = (2 ** 25, 64) if case == "2^31_elements" else (2, 4, 4, 8)
    x, r, ps = _bn_inputs((2, 4, 4, 8), True, device="meta")
    if case == "transposed":
        x = x.transpose(1, 2)
    elif case == "float64":
        x = x.double()
    elif case == "r_shape":
        r = r[:, :1]
    elif case == "mean_size":
        ps[0] = ps[0][:1]
    elif case == "mean_float64":
        ps[0] = ps[0].double()
    elif case == "r_float64":
        r = r.double()
    elif case == "mean_on_cpu":
        ps[0] = torch.zeros(8)
    else:
        x, r = torch.empty(shape, device="meta"), None
        ps = [p[:1].expand(64).contiguous() for p in ps]
    seen = []
    with pytest.raises(error), _build.cost_sink(
            lambda *a: seen.append(a)):
        be.bn_epilogue(x, *ps, r, "relu")
    assert seen == []
    if case not in ("mean_on_cpu", "2^31_elements"):
        cpu = [t if t is None else torch.zeros(t.shape, dtype=t.dtype)
               for t in (x, r, *ps)]
        y = be.bn_epilogue(cpu[0], *cpu[2:], cpu[1], "relu")
        assert y.shape == torch.broadcast_shapes(x.shape, r.shape)


def test_bn_epilogue_refuses_an_unknown_activation():
    x, r, ps = _bn_inputs((2, 4, 4, 8), True)
    with pytest.raises(ValueError):
        be.bn_epilogue(x, *ps, r, "swish")


def test_a_group_on_a_non_contiguous_input():
    """A model whose first node is a BN, fed a non-contiguous input: on the
    CPU the group runs the plain ops and gives the unfused numbers; on
    ``meta`` (the card's route) it raises, where a contiguous input reports
    one call."""
    b = Builder("bn_first", (5, 5), 8)
    b.act(b.bn(b.model.INPUT, "bn"), "relu", "r")
    m = b.build()
    assert [g.nodes for g in m.program().groups] == [("bn", "r")]
    params = _random_params(m)
    x = torch.randn(2, 5, 5, 8, generator=torch.Generator().manual_seed(4))
    x_nc = x.transpose(1, 2).contiguous().transpose(1, 2)
    assert not x_nc.is_contiguous()
    assert torch.equal(m.apply(params, x_nc),
                       _unfused(m, params, x)[m.output])
    meta = {k: {n: t.to("meta") for n, t in p.items()}
            for k, p in params.items()}
    with pytest.raises(ValueError, match="contiguous"):
        m.apply(meta, x_nc.to("meta"))
    seen = []
    with _build.cost_sink(lambda *a: seen.append(a)):
        m.apply(meta, x.to("meta"))
    assert len(seen) == 1
