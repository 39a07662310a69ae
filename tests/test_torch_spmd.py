"""The port's SPMD pipeline tier (``launch/pipeline_spmd.py``) on the CPU
against the JAX reference.

On the CPU the stages of a :class:`StageMesh` run in order with no
streams, so these tests hold the lowerings, the schedule's indexing, the
padding and the front door; the stream schedule itself is held on the card
(``tests/test_torch_cuda.py``).  Weights are the reference's init,
converted; inputs the same numpy arrays in both packages.

* ``cnn_boundary_specs`` equals the reference's function, name for name
  and shape for shape (it is plain Python over the graph).
* CNN executor vs the reference's ``model.apply``: 1e-4 (the reference
  tests' own bound; fp32 in another summation order).
* LM executor (qwen3's smoke config with bf16 weights, granite-moe's
  fp32): 2e-2 of the reference's ``api.forward`` (in the model's dtype
  throughout) and 1e-4 of the reference's fp32 stage math --
  ``repro.models.lm._block_fn(cfg)`` scanned over the blocks on fp32
  activations, as the reference's executor computes (its bf16 weights
  promoted to fp32).
* ``pipeline_logits`` (the model's dtype, bf16; vlm with its patch
  embeddings): 2e-2 of ``api.forward``.  The reference's own
  ``pipeline_logits`` fails to read its output under JAX 0.9, so it is
  not called here.
"""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi
from repro import configs as jconfigs
from repro.api.deploy import Deployment as JDeployment
from repro.launch import pipeline_spmd as jspmd
from repro.models import api as jmodels
from repro.models import cnn as jcnn
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import lm_graph as jlm_graph
from repro_torch import api as tapi
from repro_torch import configs as tconfigs
from repro_torch.api.deploy import Deployment as TDeployment
from repro_torch.core.pipeline import PipelineExecutor
from repro_torch.launch import pipeline_spmd as tspmd
from repro_torch.launch import serve as tserve
from repro_torch.models import cnn as tcnn
from repro_torch.models import layers as tlayers
from repro_torch.models import lm_graph as tlm_graph
from repro_torch.models.convert import cnn_params_from_numpy, params_from_numpy

CPU = torch.device("cpu")
SEQ = 16


def _mesh(n):
    return tspmd.default_stage_mesh(n, "cpu")


# ---------------------------------------------------------------------------
# CNN lowering
# ---------------------------------------------------------------------------
def _skipnet(layers):
    """The reference test's skip DAG: a skip connection crossing every
    cut of a 4-stage comp plan."""
    b = layers.Builder("skipnet", (16, 16), 3)
    s = b.act(b.conv(b.model.INPUT, 8, 3, name="c1"), name="c1_relu")
    x = s
    for i in range(6):
        x = b.conv(x, 8, 3, name=f"mid{i}")
    x = b.add([x, s], name="skip_add")
    b.dense(b.gap(x, name="pool"), 10, name="head")
    return b.build()


CNN_MODELS = {
    "synthetic8": lambda pkg, layers: pkg.synthetic_cnn(8, L=6, hw=32),
    "synthetic4": lambda pkg, layers: pkg.synthetic_cnn(4, L=5, hw=16),
    "skipnet": lambda pkg, layers: _skipnet(layers),
    "MobileNetV2": lambda pkg, layers: pkg.REAL_CNNS["MobileNetV2"](),
}
PKGS = {"ref": (jcnn, jlayers, japi), "port": (tcnn, tlayers, tapi)}


def _cnn(name, stages, strategy, pkg):
    cnn_mod, layers, api = PKGS[pkg]
    m = CNN_MODELS[name](cnn_mod, layers)
    pl = api.plan(api.DeploymentSpec(stages=stages, strategy=strategy),
                  graph=m.to_layer_graph())
    return m, pl


@pytest.mark.parametrize("name,stages,strategy", [
    ("synthetic8", 4, "balanced_norefine"),
    ("skipnet", 4, "comp"),
    ("MobileNetV2", 4, "balanced"),
], ids=["synthetic_cnn", "skip_dag", "mobilenetv2"])
def test_cnn_boundary_specs_match_reference(name, stages, strategy):
    jm, jpl = _cnn(name, stages, strategy, "ref")
    tm, tpl = _cnn(name, stages, strategy, "port")
    assert tpl.cuts == jpl.cuts
    assert tspmd.cnn_boundary_specs(tm, tpl) == jspmd.cnn_boundary_specs(
        jm, jpl)
    bounds, _ = tspmd.cnn_boundary_specs(tm, tpl)
    if name == "skipnet":                # rides through stage 1
        assert any("c1_relu" in dict(bs) for bs in bounds[2:]), bounds
    if name == "MobileNetV2":            # C4's plan: stage 1 is one depth
        assert tpl.cuts == [125, 126, 147]
        assert "bn_70" in dict(bounds[2]) and "bn_70" in dict(bounds[1])


@pytest.mark.parametrize("name,stages,strategy,batch,m,how,overlap", [
    ("synthetic8", 4, "balanced_norefine", 8, 4, "call", True),
    ("synthetic4", 2, "balanced_norefine", 7, 4, "run_batch", True),
    ("skipnet", 4, "comp", 7, 3, "call", False),
    ("MobileNetV2", 4, "balanced", 2, 2, "call", True),
], ids=["4_stages", "2_stages_batch_7", "skip_dag_comp", "mobilenetv2"])
def test_cnn_executor_matches_reference_apply(name, stages, strategy, batch,
                                              m, how, overlap):
    jm, _ = _cnn(name, stages, strategy, "ref")
    tm, tpl = _cnn(name, stages, strategy, "port")
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    x = np.random.default_rng(1).standard_normal(
        (batch,) + tuple(jm.input_shape)).astype(np.float32)
    expect = np.asarray(jm.apply(jax.tree.map(jnp.asarray, tree),
                                 jnp.asarray(x)))
    params = cnn_params_from_numpy(tree, CPU)
    with tspmd.SpmdPipelineExecutor.for_model(
            tm, params, tpl, mesh=_mesh(stages), n_microbatches=m,
            overlap_streaming=overlap,
            batch_size=batch if how == "call" else None) as ex:
        if how == "call":
            got = ex(torch.from_numpy(x))
        else:
            outs, stats = ex.run_batch(list(torch.from_numpy(x)))
            got = torch.stack(outs)
            assert stats["items_per_s"] > 0
            assert stats["n_microbatches"] == m
    assert got.shape == expect.shape
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-4, atol=1e-4)


def test_cnn_stage_params_are_views_of_the_streamed_row():
    """A stage's weights rebuild from its flat row as views, conv weights
    channels_last again, equal to the model's."""
    m = tcnn.synthetic_cnn(4, L=5, hw=16)
    params = m.init(CPU, torch.Generator().manual_seed(0))
    layers = list(params)
    flat, treedef, layout = tspmd._flatten_stage_params(params, layers)
    back = tspmd._unflatten_stage_params(flat, treedef, layout)
    for name in layers:
        for key, t in params[name].items():
            got = back[name][key]
            assert torch.equal(got, t)
            assert got.stride() == t.stride()
            assert got.untyped_storage().data_ptr() == \
                flat.untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# LM lowering
# ---------------------------------------------------------------------------
LM_CASES = {
    # arch, layers (None: the smoke config's), stages, strategy, bf16
    # weights (the smoke configs are fp32; in bf16 the moe's top-k choice
    # between two experts within rounding may go either way, so its fp32
    # and bf16 evaluations part at a flipped token)
    "qwen3": ("qwen3-1.7b", None, 4, "balanced_norefine", True),
    "qwen3_6_layers_comp": ("qwen3-1.7b", 6, 4, "comp", True),
    "granite_moe": ("granite-moe-1b-a400m", None, 4, "balanced_norefine",
                    False),
}
VLM = ("qwen2-vl-72b", None, 4, "balanced_norefine", True)


def _lm(case):
    """Both packages' smoke configs of the case, the reference's init
    (converted), and the port's plan (the reference's cuts)."""
    arch, layers, stages, strategy, bf16 = (VLM if case == "vlm"
                                            else LM_CASES[case])
    over = {} if layers is None else {"n_layers": layers}
    jcfg = dataclasses.replace(jconfigs.get(arch).smoke_config(), **over)
    tcfg = dataclasses.replace(tconfigs.get(arch).smoke_config(), **over)
    if bf16:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    jparams = jmodels.init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    spec = dict(stages=stages, strategy=strategy)
    tpl = tapi.plan(tapi.DeploymentSpec(**spec),
                    graph=tlm_graph.lm_layer_graph(tcfg, seq_len=SEQ))
    jpl = japi.plan(japi.DeploymentSpec(**spec),
                    graph=jlm_graph.lm_layer_graph(jcfg, seq_len=SEQ))
    assert tpl.cuts == jpl.cuts
    return jcfg, jparams, tcfg, tparams, tpl


def _reference_fp32_stage_math(jcfg, jparams, tokens):
    """The reference executor's numerics without its mesh: the embedded
    activations cast to fp32, ``_block_fn`` scanned over the blocks (jnp
    promotes each bf16 weight), the unembedding on the fp32 hidden."""
    x = jlm.embed_tokens(jcfg, jparams, tokens).astype(jnp.float32)
    positions = jnp.arange(tokens.shape[1])[None, :]
    fn = jlm._block_fn(jcfg)
    x, _ = jax.lax.scan(lambda x, bp: (fn(x, bp, positions), None), x,
                        jparams["blocks"])
    return jlm.unembed(jcfg, jparams, x)


@pytest.fixture(scope="module", params=list(LM_CASES))
def lm_run(request):
    """One executor per case: batch 7 (padded to 8) over m = 4."""
    jcfg, jparams, tcfg, tparams, tpl = _lm(request.param)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (7, SEQ))
    jtok = jnp.asarray(tokens, jnp.int32)
    with tspmd.SpmdPipelineExecutor.for_model(
            tcfg, tparams, tpl, mesh=_mesh(tpl.n_stages), n_microbatches=4,
            batch_size=7, seq_len=SEQ) as ex:
        got = ex(torch.from_numpy(tokens)).numpy()
        pred = ex.predicted_stage_times()
        ach = ex.achieved_stage_times(reps=2, warmup=1)
        fill = ex.fill_s
    return dict(
        case=request.param, got=got, pred=pred, ach=ach, fill=fill,
        counts=tserve.stage_block_counts(tpl, tcfg.n_layers),
        forward=np.asarray(jmodels.forward(jcfg, jparams,
                                           {"tokens": jtok})),
        fp32=np.asarray(_reference_fp32_stage_math(jcfg, jparams, jtok)))


def test_lm_executor_matches_reference_forward(lm_run):
    assert lm_run["got"].shape == lm_run["forward"].shape
    assert lm_run["got"].dtype == np.float32
    err = np.abs(lm_run["got"] - lm_run["forward"]).max()
    assert err < 2e-2, err


def test_lm_executor_matches_reference_fp32_stage_math(lm_run):
    np.testing.assert_allclose(lm_run["got"], lm_run["fp32"], rtol=1e-4,
                               atol=1e-4)
    if lm_run["case"] == "qwen3_6_layers_comp":
        assert len(set(lm_run["counts"])) > 1, lm_run["counts"]


def test_lm_executor_probe_surface(lm_run):
    assert len(lm_run["pred"]) == len(lm_run["ach"]) == 4
    assert all(t > 0 for t in lm_run["ach"])
    assert lm_run["fill"] > 0


@pytest.mark.parametrize("case", ["qwen3", "qwen3_6_layers_comp", "vlm"])
def test_pipeline_logits_match_reference_forward(case):
    """The reference's two SPMD pipeline tests, held against its
    ``api.forward`` (bf16 in both); vlm: the patch embeddings go first
    and every stream takes the default positions."""
    jcfg, jparams, tcfg, tparams, tpl = _lm(case)
    rng = np.random.default_rng(1)
    n_tok = SEQ - (jcfg.n_patches if case == "vlm" else 0)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (8, n_tok))}
    if case == "vlm":
        batch["embeds"] = rng.standard_normal(
            (8, jcfg.n_patches, jcfg.d_model)).astype(np.float32)
    expect = np.asarray(jmodels.forward(
        jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = tspmd.pipeline_logits(
        tcfg, _mesh(4), tpl, tparams,
        {k: torch.from_numpy(v) for k, v in batch.items()},
        n_microbatches=4)
    assert got.shape == expect.shape == (8, SEQ, jcfg.vocab)
    err = np.abs(got.numpy() - expect).max()
    assert err < 2e-2 * max(1.0, np.abs(expect).max()), err


def test_pipeline_hidden_refuses_an_indivisible_batch():
    _, _, tcfg, tparams, tpl = _lm("qwen3")
    hidden = tspmd.make_pipeline_hidden(tcfg, _mesh(4), tpl, 4)
    with pytest.raises(ValueError, match="multiple of 4 microbatches"):
        hidden(tparams, {"tokens": torch.zeros((6, SEQ), dtype=torch.long)})


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "rwkv6-1.6b",
                                  "recurrentgemma-9b", "whisper-tiny"],
                         ids=["vlm", "ssm", "hybrid", "encdec"])
def test_for_lm_refuses_the_reference_families(arch):
    """Both packages refuse every family but dense and moe, with one
    message, before building anything."""
    raised = []
    for configs, api, graph, spmd in (
            (jconfigs, japi, jlm_graph, jspmd),
            (tconfigs, tapi, tlm_graph, tspmd)):
        cfg = configs.get(arch).smoke_config()
        pl = api.plan(api.DeploymentSpec(stages=2, strategy="balanced"),
                      graph=graph.lm_layer_graph(cfg, seq_len=SEQ))
        with pytest.raises(ValueError, match="dense/moe") as exc:
            spmd.SpmdPipelineExecutor.for_model(cfg, {}, pl)
        raised.append(str(exc.value))
    assert raised[0] == raised[1]


def test_for_model_refuses_other_objects():
    m, pl = _cnn("synthetic4", 2, "balanced_norefine", "port")
    with pytest.raises(TypeError, match="GraphModel or an LMConfig"):
        tspmd.SpmdPipelineExecutor.for_model(object(), {}, pl)


# ---------------------------------------------------------------------------
# weight streaming
# ---------------------------------------------------------------------------
def test_stream_stage_weights_overlap_matches_serial():
    """Overlapped and serial streaming place equal tensors, each a copy
    (the overlap only reorders copies against the bring-up)."""
    rng = np.random.default_rng(0)
    stages = [{"w": torch.from_numpy(rng.standard_normal(64)
                                     .astype(np.float32)),
               "b": [torch.from_numpy(rng.standard_normal(8)
                                      .astype(np.float32))]}
              for _ in range(4)]
    ran = []
    g1, c1, r1 = tspmd.stream_stage_weights(
        _mesh(4), stages, overlap=True, compile_fn=lambda: ran.append(1) or 7)
    g2, c2, r2 = tspmd.stream_stage_weights(_mesh(4), stages, overlap=False)
    assert (c1, c2, ran) == (7, None, [1])
    for a, b, src in zip(g1, g2, stages):
        for key in ("w", "b"):
            x, y, z = (a[key], b[key], src[key]) if key == "w" else (
                a[key][0], b[key][0], src[key][0])
            assert torch.equal(x, y) and torch.equal(x, z)
            assert x.data_ptr() != z.data_ptr()
    assert r1.fill_s > 0 and r2.fill_s > 0
    assert 0 <= r1.blocked_s <= r1.fill_s
    assert 0 <= r2.blocked_s <= r2.fill_s


def test_host_stage_weights_restream_what_the_executor_streamed():
    """The executor keeps no host copy of its weights; a fill is measured
    again from ``host_stage_weights`` with the executor's bring-up: one
    flat row per stage that rebuilds the stage's parameters (CNN), each
    stage's blocks in their own dtype (LM)."""
    m, pl = _cnn("synthetic4", 2, "balanced_norefine", "port")
    params = m.init(CPU, torch.Generator().manual_seed(0))
    with tspmd.SpmdPipelineExecutor.for_cnn(m, params, pl, mesh=_mesh(2),
                                            batch_size=4) as ex:
        rows = tspmd.host_stage_weights(m, params, pl, pin=False)
        assert [r.dtype for r in rows] == [torch.float32] * 2
        for overlap in (True, False):
            got, _, rep = tspmd.stream_stage_weights(
                ex.mesh, rows, overlap=overlap, compile_fn=ex.bring_up)
            assert 0 <= rep.blocked_s <= rep.fill_s
            for layers, row in zip(pl.stage_layers, got):
                flat, treedef, layout = tspmd._flatten_stage_params(
                    params, layers)
                assert torch.equal(row[:flat.numel()], flat)
                assert not row[flat.numel():].any()
    _, _, tcfg, tparams, tpl = _lm("qwen3_6_layers_comp")
    counts = tserve.stage_block_counts(tpl, tcfg.n_layers)
    stages = tspmd.host_stage_weights(tcfg, tparams, tpl, pin=False)
    assert [len(blocks) for blocks in stages] == counts
    flat = [bp for blocks in stages for bp in blocks]
    for a, b in zip(flat, tparams["blocks"]):
        for x, y in zip(tspmd.tree_flatten(a)[0], tspmd.tree_flatten(b)[0]):
            assert x.dtype == torch.bfloat16 and torch.equal(x, y)
            assert x.data_ptr() != y.data_ptr()


def test_stage_mesh_on_the_cpu_has_no_streams():
    mesh = _mesh(3)
    assert mesh.n_stages == 3 and mesh.streams == (None,) * 3
    assert tspmd._stage_devices(mesh) == [CPU] * 3
    assert not mesh.on_card


def test_default_stage_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tspmd.default_stage_mesh(2)


# ---------------------------------------------------------------------------
# the front door (the reference's tests/test_spmd_subprocess.py:306-374)
# ---------------------------------------------------------------------------
def _replicated_plan(api, cnn):
    pl = api.plan(api.DeploymentSpec(stages=2, strategy="balanced_norefine"),
                  graph=cnn.synthetic_cnn(4, L=4, hw=16).to_layer_graph())
    stages = [dataclasses.replace(pl.stages[0], replicas=2), pl.stages[1]]
    return dataclasses.replace(pl, stages=stages)


def test_spmd_backend_replicated_plan_falls_back_to_host(caplog):
    pl = _replicated_plan(tapi, tcnn)
    dep = TDeployment.from_plan(pl, stage_fns=[lambda x: x, lambda x: x])
    with caplog.at_level(logging.WARNING, logger="repro_torch.api.deploy"):
        ex = dep.executor(backend="spmd")
    try:
        assert isinstance(ex, PipelineExecutor)
        assert any("falling back" in r.message for r in caplog.records)
    finally:
        ex.stop()


def test_spmd_backend_requires_model_and_params():
    model = tcnn.synthetic_cnn(4, L=4, hw=16)
    pl = tapi.plan(tapi.DeploymentSpec(stages=2,
                                       strategy="balanced_norefine"),
                   graph=model.to_layer_graph())
    dep = TDeployment.from_plan(pl)
    with pytest.raises(ValueError, match="model"):
        dep.executor(backend="spmd")
    with pytest.raises(ValueError, match="model"):
        dep.executor(backend="spmd", model=model)
    with pytest.raises(ValueError, match="'host' or 'spmd'"):
        dep.executor(backend="tpu")


def test_require_unreplicated_direct_raises_as_the_reference():
    messages = []
    for api, cnn, spmd in ((japi, jcnn, jspmd), (tapi, tcnn, tspmd)):
        pl = _replicated_plan(api, cnn)
        assert not spmd.plan_supports_spmd(pl)
        with pytest.raises(NotImplementedError, match="replicated") as exc:
            spmd._require_unreplicated(pl)
        messages.append(str(exc.value))
        with pytest.raises(NotImplementedError, match="replicated"):
            spmd.SpmdPipelineExecutor.for_cnn(
                cnn.synthetic_cnn(4, L=4, hw=16), {}, pl)
    assert messages[0] == messages[1]


def test_spmd_backend_through_the_front_door_runs_the_cnn():
    """``executor(backend="spmd", model=, params=)`` of a CNN deployment
    gives the SPMD executor, its output the direct forward's."""
    m = tcnn.synthetic_cnn(4, L=5, hw=16)
    params = m.init(CPU, torch.Generator().manual_seed(0))
    dep = tserve.deploy_cnn(m, params, tapi.DeploymentSpec(
        stages=2, strategy="balanced_norefine", backend="spmd"), CPU)
    x = torch.randn((5,) + m.input_shape,
                    generator=torch.Generator().manual_seed(1))
    with dep.executor(model=m, params=params, mesh=_mesh(2),
                      n_microbatches=2, batch_size=5) as ex:
        assert isinstance(ex, tspmd.SpmdPipelineExecutor)
        assert ex.kind == "cnn"
        got = ex(x)
    torch.testing.assert_close(got, m.apply(params, x), rtol=1e-5,
                               atol=1e-5)


def test_reference_front_door_refuses_as_the_port():
    """Without model and params both packages' front doors refuse the
    same plan with one message."""
    raised = []
    for api, dep_cls, cnn in ((japi, JDeployment, jcnn),
                              (tapi, TDeployment, tcnn)):
        pl = api.plan(api.DeploymentSpec(stages=2,
                                         strategy="balanced_norefine"),
                      graph=cnn.synthetic_cnn(4, L=4, hw=16)
                      .to_layer_graph())
        with pytest.raises(ValueError) as exc:
            dep_cls.from_plan(pl).executor(backend="spmd")
        raised.append(str(exc.value))
    assert raised[0] == raised[1]


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------
def test_serve_cli_spmd_backend_on_cpu():
    res = tserve.main(["--smoke", "--device", "cpu", "--backend", "spmd",
                       "--stages", "2", "--requests", "3", "--seq", "16",
                       "--microbatch", "2"])
    assert res["max_err"] < 2e-2
    assert len(res["outs"]) == 3
    assert res["stats"]["n_microbatches"] == 2
    assert len(res["predicted_s"]) == len(res["achieved_s"]) == 2
    assert all(t > 0 for t in res["achieved_s"])


def test_serve_cli_spmd_backend_exits_on_a_replicated_plan():
    with pytest.raises(SystemExit, match="replicated stages"):
        tserve.main(["--smoke", "--device", "cpu", "--backend", "spmd",
                     "--device-budget", "6", "--requests", "2",
                     "--seq", "16"])
