"""The port's CNN path (``models/layers.py``, ``models/cnn.py``, the CNN
stage functions and the front door's ``cnn:`` refs) against the JAX
package's, on the CPU.

* Graphs: every node of all 21 Table-1 models and the synthetic CNN equals
  the reference's (name, inputs, params, MACs, output shape, kind,
  activation bytes), and so does ``to_layer_graph()``; plans over them are
  the reference's (exact).
* Forwards on the reference's weights (converted HWIO -> OIHW), the same
  numpy inputs: each op kind alone at odd sizes and stride 2 within 1e-5
  (fp32 arithmetic in another order); whole models within 2e-4, the
  reference's own tolerance (``tests/test_cnn_models.py``).
* Pipelines: 3- and 4-stage ``apply_subset`` pipelines through the copied
  executor (one with a replicated stage), and the front door's server over
  ``cnn_stage_fns``, equal the direct forward (2e-4, as the reference's
  pipeline tests; 1e-6 and exact where the same CPU kernels run).
* recurrentgemma's windowed prefill above ``local_window`` (S = 64 over the
  smoke window of 16) equals the reference's forward within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi
from repro import configs as jconfigs
from repro.models import api as jmodels
from repro.models import cnn as jcnn
from repro.models import layers as jlayers
from repro_torch import api as tapi
from repro_torch import configs as tconfigs
from repro_torch.core.pipeline import PipelineExecutor
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tmodels
from repro_torch.models import cnn as tcnn
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import cnn_params_from_numpy, params_from_numpy

CPU = torch.device("cpu")
ZOO = sorted(jcnn.REAL_CNNS) + ["synthetic_cnn(64)"]


def _build(pkg, name):
    if name == "synthetic_cnn(64)":
        return pkg.synthetic_cnn(64)
    return pkg.REAL_CNNS[name]()


def _model_nodes(m):
    return [(n.name, tuple(n.inputs), n.params_count, n.macs, n.out_shape,
             n.kind, n.act_dtype_bytes) for n in m.nodes.values()]


def _graph_nodes(g):
    return [(n.name, n.params, n.macs, n.out_bytes, n.weight_bytes, n.kind,
             tuple(g.predecessors(n.name))) for n in g.nodes.values()]


def _weights(jm, seed=0, bn_stats=True):
    """The reference's init, BN statistics made non-trivial (its init is
    the identity), as numpy; and the port's converted copy."""
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for p in tree.values():
        if bn_stats and "gamma" in p:
            c = p["gamma"].shape
            p["gamma"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            p["beta"] = rng.normal(0, 0.1, c).astype(np.float32)
            p["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            p["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        if "b" in p:
            p["b"] = rng.normal(0, 0.1, p["b"].shape).astype(np.float32)
    return tree, cnn_params_from_numpy(tree, CPU)


def _forwards(jm, tm, scale=1.0, seed=0):
    tree, tparams = _weights(jm, seed)
    x = (np.random.default_rng(seed + 1).normal(
        size=(2,) + tuple(jm.input_shape)) * scale).astype(np.float32)
    expect = np.asarray(jax.jit(jm.apply)(jax.tree.map(jnp.asarray, tree),
                                          jnp.asarray(x)))
    got = tm.apply(tparams, torch.from_numpy(x))
    return got, expect, tparams, x


# ---------------------------------------------------------------------------
# graphs and plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ZOO)
def test_graph_equals_reference(name):
    jm, tm = _build(jcnn, name), _build(tcnn, name)
    assert (tm.name, tm.input_shape, tm.output) == (jm.name, jm.input_shape,
                                                    jm.output)
    assert _model_nodes(tm) == _model_nodes(jm)
    assert (tm.total_params, tm.total_macs) == (jm.total_params,
                                                jm.total_macs)
    jg, tg = jm.to_layer_graph(), tm.to_layer_graph()
    assert tg.name == jg.name and tg.depth == jg.depth
    assert _graph_nodes(tg) == _graph_nodes(jg)
    ref = ("synthetic-cnn:64" if name.startswith("synthetic")
           else f"cnn:{name}")
    assert (_graph_nodes(tapi.resolve_model_graph(ref))
            == _graph_nodes(japi.resolve_model_graph(ref)))


@pytest.mark.parametrize("name", ZOO)
def test_plans_equal_reference(name):
    ref = ("synthetic-cnn:64" if name.startswith("synthetic")
           else f"cnn:{name}")
    for strategy, stages in (("balanced", 4), ("opt", 3), ("comp", 2)):
        jpl = japi.plan(japi.DeploymentSpec(model=ref, stages=stages,
                                            strategy=strategy))
        tpl = tapi.plan(tapi.DeploymentSpec(model=ref, stages=stages,
                                            strategy=strategy))
        assert tpl.cuts == jpl.cuts, strategy
        assert tpl.stage_layers == jpl.stage_layers, strategy
        assert tpl.report.to_dict() == jpl.report.to_dict(), strategy


def test_table1_totals_track_the_paper():
    """The zoo's params and MACs within the reference's bounds of the
    paper's Table 1 (``tests/test_cnn_models.py``: params 8%, MACs 12%,
    the MACs of NASNetMobile and the V2 ResNets exempt)."""
    exempt = {"NASNetMobile", "ResNet50V2", "ResNet101V2", "ResNet152V2"}
    for name, (p_m, macs_m) in tcnn.TABLE1.items():
        m = tcnn.REAL_CNNS[name]()
        assert abs(m.total_params / 1e6 - p_m) / p_m < 0.08, name
        if name not in exempt:
            assert abs(m.total_macs / 1e6 - macs_m) / macs_m < 0.12, name


# ---------------------------------------------------------------------------
# each op kind alone, at odd sizes and stride 2
# ---------------------------------------------------------------------------
def _one_op(op):
    def build(pkg):
        b = pkg.Builder("op", (13, 11), 6)
        x = b.model.INPUT
        if isinstance(op, tuple):
            kind, *args = op
            getattr(b, kind)(x, *args)
        elif op == "add":
            b.add([b.conv(x, 4, 3, 2, name="a"),
                   b.conv(x, 4, 1, 2, name="b")])
        elif op == "concat":
            b.concat([b.conv(x, 4, 3, 2, name="a"),
                      b.conv(x, 5, (1, 7), 2, name="b"),
                      b.pool(x, "max", 3, 2, "same", "c")])
        elif op == "bn":
            b.bn(x)
        elif op == "gap":
            b.gap(x)
        elif op == "dense":
            b.dense(b.conv(x, 3, 3, 2, "valid", name="c"), 7)
        else:
            b.act(x, op[4:])
        return b.build()
    return build


OPS = {
    "conv 7x7/2 same": ("conv", 8, 7, 2, "same"),
    "conv 7x7/2 valid": ("conv", 8, 7, 2, "valid"),
    "conv 1x7 same": ("conv", 5, (1, 7), 1, "same"),
    "conv 7x1/2 same": ("conv", 5, (7, 1), 2, "same"),
    "conv 3x3/2 same no bias": ("conv", 4, 3, 2, "same", False),
    "conv 1x1/2 valid": ("conv", 4, 1, 2, "valid"),
    "dwconv 3x3/2 same x1": ("dwconv", 3, 2, "same"),
    "dwconv 5x5/2 valid x1": ("dwconv", 5, 2, "valid"),
    "dwconv 3x3/2 same x2": ("dwconv", 3, 2, "same", True, None, 2),
    "dwconv 3x3/1 same x2": ("dwconv", 3, 1, "same", False, None, 2),
    "maxpool 3/2 same": ("pool", "max", 3, 2, "same"),
    "maxpool 3/2 valid": ("pool", "max", 3, 2, "valid"),
    "maxpool 2/2 same": ("pool", "max", 2, 2, "same"),
    "avgpool 3/2 same": ("pool", "avg", 3, 2, "same"),
    "avgpool 3/1 same": ("pool", "avg", 3, 1, "same"),
    "avgpool 3/2 valid": ("pool", "avg", 3, 2, "valid"),
    "bn": "bn", "relu": "act_relu", "relu6": "act_relu6",
    "swish": "act_swish", "sigmoid": "act_sigmoid", "gap": "gap",
    "dense": "dense", "add": "add", "concat": "concat",
}


@pytest.mark.parametrize("op", list(OPS))
def test_op_matches_reference(op):
    build = _one_op(OPS[op])
    jm, tm = build(jlayers), build(tlayers)
    assert _model_nodes(tm) == _model_nodes(jm)
    # scale 4: relu6 clips, sigmoid saturates, max pools see negatives
    got, expect, _, _ = _forwards(jm, tm, scale=4.0)
    assert tuple(got.shape) == expect.shape
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=1e-5)


def test_same_pads_are_xla_s():
    """The 7x7/2 stem at 224 pads 2 before and 3 after; a 3x3/2 conv at an
    even size 1 after only; stride 1 is symmetric."""
    assert tlayers.same_pads(224, 7, 2) == (2, 3)
    assert tlayers.same_pads(224, 3, 2) == (0, 1)
    assert tlayers.same_pads(13, 3, 2) == (1, 1)
    assert tlayers.same_pads(11, 7, 1) == (3, 3)
    assert tlayers.same_pads(5, 1, 2) == (0, 0)


def test_activations_stay_nhwc_and_weights_channels_last():
    tm = tcnn.synthetic_cnn(6, hw=9)
    params = tm.init(CPU, torch.Generator(CPU).manual_seed(0))
    assert params["conv0"]["w"].shape == (6, 3, 3, 3)
    assert params["conv0"]["w"].is_contiguous(
        memory_format=torch.channels_last)
    y = tm.apply(params, torch.randn(2, 9, 9, 3))
    assert y.shape == (2, 9, 9, 6) and y.is_contiguous()


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["synthetic_cnn(64)", "ResNet50",
                                  "InceptionV3", "MobileNetV2", "Xception"])
def test_forward_matches_reference(name):
    """At the published input sizes (224; 299 for InceptionV3 and
    Xception), batch 2."""
    jm, tm = _build(jcnn, name), _build(tcnn, name)
    got, expect, _, _ = _forwards(jm, tm)
    assert tuple(got.shape) == expect.shape and np.isfinite(expect).all()
    np.testing.assert_allclose(got.numpy(), expect, rtol=2e-4, atol=2e-4)


def _mini_inception(pkg):
    """The branchy model of the reference's pipeline test."""
    b = pkg.Builder("mini_inception", (32, 32), 3)
    x = b.conv_bn(b.model.INPUT, 8, 3, 1, "same", "relu", "stem")
    for i in range(3):
        b1 = b.conv_bn(x, 8, 1, 1, "same", "relu", f"m{i}_b1")
        b2 = b.conv_bn(x, 6, 1, 1, "same", "relu", f"m{i}_b2a")
        b2 = b.conv_bn(b2, 8, 3, 1, "same", "relu", f"m{i}_b2b")
        b3 = b.pool(x, "avg", 3, 1, "same", f"m{i}_b3p")
        b3 = b.conv_bn(b3, 8, 1, 1, "same", "relu", f"m{i}_b3")
        x = b.concat([b1, b2, b3], f"m{i}_cat")
    x = b.gap(x, "gap")
    b.dense(x, 10, name="head")
    return b.build()


@pytest.mark.parametrize("which,stages", [("chain", 3), ("branchy", 4)])
def test_pipelined_model_equals_direct(which, stages):
    """Horizontal cuts across open paths (paper Fig. 8): each stage runs
    ``apply_subset`` in the copied executor; the output equals the direct
    forward and the reference's."""
    if which == "chain":
        jm, tm = jcnn.synthetic_cnn(12, hw=32), tcnn.synthetic_cnn(12, hw=32)
    else:
        jm, tm = _mini_inception(jlayers), _mini_inception(tlayers)
    got, expect, params, x = _forwards(jm, tm)
    pl = tapi.plan(tapi.DeploymentSpec(stages=stages,
                                       strategy="balanced_norefine"),
                   graph=tm.to_layer_graph())
    assert pl.n_stages == stages

    def stage_fn(layers):
        return lambda boundary: tm.apply_subset(params, boundary, layers)

    ex = PipelineExecutor([stage_fn(ls) for ls in pl.stage_layers])
    outs, _ = ex.run_batch([{tm.INPUT: torch.from_numpy(x)}])
    np.testing.assert_allclose(outs[0][tm.output].numpy(), got.numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(outs[0][tm.output].numpy(), expect,
                               rtol=2e-4, atol=2e-4)


def test_replicated_cnn_stage_keeps_request_order():
    """A plan's middle stage on 3 replicas (the executor's round-robin
    fan-out, as ``tests/test_streaming_executor.py`` runs it): each of 7
    distinct requests comes back in order, equal to its own direct
    forward (1e-6: the same CPU kernels on other threads)."""
    tm = tcnn.synthetic_cnn(8, hw=16)
    params = tm.init(CPU, torch.Generator(CPU).manual_seed(0))
    pl = tapi.plan(tapi.DeploymentSpec(stages=3,
                                       strategy="balanced_norefine"),
                   graph=tm.to_layer_graph())
    fns = tserve.cnn_stage_fns(tm, params, pl, CPU)
    xs = [torch.randn(1, 16, 16, 3, generator=torch.Generator().manual_seed(i))
          for i in range(7)]
    with PipelineExecutor(fns, replicas=[1, 3, 1]) as ex:
        futs = [ex.submit({tm.INPUT: x}) for x in xs]
        outs = [f.result(60) for f in futs]
    for x, out in zip(xs, outs):
        torch.testing.assert_close(out[tm.output], tm.apply(params, x),
                                   rtol=1e-6, atol=1e-6)


def test_deployed_cnn_serves_the_direct_forward():
    """``deploy(cnn:..., stage_fn_builder=cnn_stage_fns)`` through the
    copied server: every served output equals the direct forward (same
    kernels on one device: exact), across a hot resize of the plan."""
    tm = tcnn.synthetic_cnn(8, hw=24)
    params = tm.init(CPU, torch.Generator(CPU).manual_seed(0))
    dep = tapi.deploy(
        tapi.DeploymentSpec(model="synthetic-cnn:8", stages=3,
                            strategy="balanced"),
        graph=tm.to_layer_graph(),
        stage_fn_builder=lambda p: tserve.cnn_stage_fns(tm, params, p, CPU))
    xs = [torch.randn(1, 24, 24, 3, generator=torch.Generator().manual_seed(i))
          for i in range(5)]
    reqs = [{tm.INPUT: x} for x in xs]
    outs, snap, _ = tserve.serve_stream(dep, reqs)
    assert snap["requests"] == len(reqs) and len(snap["stage_busy_s"]) == 3
    for x, out in zip(xs, outs):
        assert set(out) == {tm.output}
        torch.testing.assert_close(out[tm.output], tm.apply(params, x),
                                   rtol=0, atol=0)
    dep.reconfigure(stages=2)
    outs, snap, _ = tserve.serve_stream(dep, reqs[:2])
    assert len(snap["stage_busy_s"]) == 2
    torch.testing.assert_close(outs[1][tm.output], tm.apply(params, xs[1]),
                               rtol=0, atol=0)


@pytest.mark.parametrize("stages", [4, 6])
def test_skip_connection_over_a_whole_stage(stages):
    """MobileNetV2's balanced plans put a whole stage inside one residual
    (4 stages: stage 1 is depth 126 alone; ``bn_70`` feeds an add in
    stage 2).  The port's ``apply_subset`` passes such a boundary
    activation on, so the stage chain equals the reference's direct
    forward (2e-4, the whole-model tolerance); the reference's own chain
    drops it and raises ``KeyError``."""
    jm, tm = jcnn.REAL_CNNS["MobileNetV2"](), tcnn.REAL_CNNS["MobileNetV2"]()
    assert tm.depths() == tm.to_layer_graph().depths()
    tree, tparams = _weights(jm)
    x = np.random.default_rng(1).normal(
        size=(1,) + tuple(jm.input_shape)).astype(np.float32)
    expect = np.asarray(jm.apply(jax.tree.map(jnp.asarray, tree),
                                 jnp.asarray(x)))
    pl = tapi.plan(tapi.DeploymentSpec(stages=stages, strategy="balanced"),
                   graph=tm.to_layer_graph())
    boundary = {tm.INPUT: torch.from_numpy(x)}
    for layers in pl.stage_layers:
        boundary = tm.apply_subset(tparams, boundary, layers)
    np.testing.assert_allclose(boundary[tm.output].numpy(), expect,
                               rtol=2e-4, atol=2e-4)
    jb = {jm.INPUT: jnp.asarray(x)}
    with pytest.raises(KeyError):
        for layers in pl.stage_layers:
            jb = jm.apply_subset(jax.tree.map(jnp.asarray, tree), jb, layers)


# ---------------------------------------------------------------------------
# recurrentgemma: windowed prefill above the window
# ---------------------------------------------------------------------------
def test_recurrentgemma_prefill_above_the_window_matches_reference():
    arch = "recurrentgemma-9b"
    jcfg = jconfigs.get(arch).smoke_config()
    tcfg = tconfigs.get(arch).smoke_config()
    assert tcfg.local_window == 16
    jparams = jmodels.init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    # 64: above the window, and a multiple of the reference's q_chunk (32)
    tokens = np.random.default_rng(64).integers(
        0, tcfg.vocab, (2, 64)).astype(np.int32)
    expect = jmodels.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    got = tmodels.forward(tcfg, tparams, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, 64, tcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-4,
                               atol=1e-4)
