"""The SPMD tier's stages on several devices (``launch/pipeline_spmd.py``),
on the CPU against the JAX reference.

No machine here has a card, let alone four, so the cross-device route is
driven on a mesh whose last stages sit on ``meta``: ``(cpu, cpu, meta,
meta)``.  There each stage's weights lie on its own device, the hop out
of stage 1 (:func:`_hop`, from the CPU to ``meta``) is a real tensor
that equals the reference's composition at that cut, and the output comes
out on the last stage's device with the right shape and dtype.  The
schedule on real cards is held by ``chip_smoke.py``'s four-card phase and
the multi-card tests of ``tests/test_torch_cuda.py``.

* :func:`stage_cards`: stage ``s`` on card ``s * k // S``, contiguous,
  every card at least one stage (the reference's one stage a device when
  ``k = S``).
* :func:`default_stage_mesh` raises for more cards than visible (as the
  reference's mesh raises for fewer devices than stages), for more cards
  than stages and for ``cards`` on the CPU; ``cards=1`` keeps today's
  executors, equal to the reference.
* Tolerances: 1e-4 in fp32 (the reference tests' own bound), as in
  ``tests/test_torch_spmd.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi
from repro import configs as jconfigs
from repro.launch import pipeline_spmd as jspmd
from repro.models import api as jmodels
from repro.models import cnn as jcnn
from repro.models import lm as jlm
from repro_torch import api as tapi
from repro_torch import configs as tconfigs
from repro_torch.kernels import _build
from repro_torch.launch import pipeline_spmd as tspmd
from repro_torch.launch import serve as tserve
from repro_torch.models import cnn as tcnn
from repro_torch.models import lm_graph as tlm_graph
from repro_torch.models.convert import cnn_params_from_numpy, params_from_numpy

CPU = torch.device("cpu")
META = torch.device("meta")
SEQ = 16
MIXED = (CPU, CPU, META, META)


def _mixed_mesh(devices=MIXED):
    n = len(devices)
    return tspmd.StageMesh(tuple(devices), (None,) * n, (None,) * n)


# ---------------------------------------------------------------------------
# the stage-to-card map and the mesh's refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stages,cards", [
    (4, 1), (4, 2), (4, 4), (5, 2), (6, 4), (8, 3), (32, 4), (7, 7)])
def test_stage_cards_are_contiguous_groups(stages, cards):
    got = tspmd.stage_cards(stages, cards)
    assert got == [s * cards // stages for s in range(stages)]
    assert got == sorted(got)                       # contiguous
    assert set(got) == set(range(cards))            # every card a stage
    sizes = [got.count(c) for c in range(cards)]
    assert max(sizes) - min(sizes) <= 1
    if cards == stages:                             # the reference's mesh
        assert got == list(range(stages))


@pytest.mark.parametrize("stages,cards", [(2, 4), (3, 0), (1, 2)])
def test_stage_cards_refuse_a_card_without_a_stage(stages, cards):
    with pytest.raises(ValueError, match="every card needs at least one"):
        tspmd.stage_cards(stages, cards)


def test_mesh_raises_for_more_cards_than_visible(monkeypatch):
    """As the reference's ``default_stage_mesh`` raises for fewer devices
    than stages; nothing is folded onto the cards there are."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="needs >= 4 CUDA devices; this "
                                         "process sees 2"):
        tspmd.default_stage_mesh(4, "cuda", cards=4)
    with pytest.raises(ValueError, match="needs >= 3"):
        tspmd.default_stage_mesh(6, cards=3)
    # the reference raises for its fewer devices in the same way
    with pytest.raises(ValueError, match="needs >= 4 devices"):
        jspmd.default_stage_mesh(4)


def test_mesh_raises_for_more_cards_than_stages(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with pytest.raises(ValueError, match="4 cards for 2 stages"):
        tspmd.default_stage_mesh(2, "cuda", cards=4)
    with pytest.raises(ValueError, match="starts at cuda:0"):
        tspmd.default_stage_mesh(4, "cuda:1", cards=2)


class _FakeStream:
    """Stands in for ``torch.cuda.Stream`` here: remembers its device."""

    def __init__(self, device):
        self.device = torch.device(device)


@pytest.mark.parametrize("stages,cards", [(4, 1), (4, 2), (4, 4), (6, 4)])
def test_mesh_puts_each_stage_on_its_card(monkeypatch, stages, cards):
    """The card branch of the mesh, with four cards faked: stage ``s`` on
    ``cuda:(s * k // S)`` (``cards=1``: the current card, an index given),
    a stream a stage on its card, one copy stream a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    mesh = tspmd.default_stage_mesh(stages, "cuda", cards=cards)
    assert mesh.devices == tuple(torch.device("cuda", c) for c in
                                 tspmd.stage_cards(stages, cards))
    assert mesh.cards == tuple(torch.device("cuda", c)
                               for c in range(cards))
    assert [st.device for st in mesh.streams] == list(mesh.devices)
    assert len({id(st) for st in mesh.streams}) == stages
    assert [st.device for st in mesh.copy_streams] == list(mesh.devices)
    assert len({id(st) for st in mesh.copy_streams}) == cards
    assert mesh.on_card
    one = tspmd.default_stage_mesh(3, "cuda:2")
    assert one.devices == (torch.device("cuda", 2),) * 3


@pytest.mark.parametrize("cards", [0, 2, 4])
def test_mesh_refuses_cards_on_the_cpu(cards):
    with pytest.raises(ValueError, match="needs CUDA devices"):
        tspmd.default_stage_mesh(4, "cpu", cards=cards)


@pytest.mark.parametrize("cards", [None, 1])
def test_one_card_mesh_on_the_cpu_is_the_stages_in_order(cards):
    mesh = tspmd.default_stage_mesh(3, "cpu", cards=cards)
    assert mesh.devices == (CPU,) * 3 and mesh.cards == (CPU,)
    assert mesh.streams == mesh.copy_streams == (None,) * 3
    assert tspmd._stage_devices(mesh) == [CPU] * 3
    assert tspmd.peer_access(mesh) == {}
    assert not mesh.on_card


def test_stage_mesh_needs_a_device_stream_and_copy_stream_a_stage():
    with pytest.raises(ValueError, match="3 devices, 2 streams"):
        tspmd.StageMesh((CPU,) * 3, (None,) * 2, (None,) * 3)
    mesh = _mixed_mesh()
    assert mesh.n_stages == 4 and mesh.cards == (CPU, META)
    assert tspmd._stage_devices(mesh) == list(MIXED)


# ---------------------------------------------------------------------------
# the hop
# ---------------------------------------------------------------------------
def test_hop_off_a_card_moves_the_tensor_to_the_reader():
    x = torch.arange(6.0).reshape(2, 3)
    assert tspmd._hop(x, None, CPU, None) is x
    y = tspmd._hop(x, None, META, None)
    assert y.device == META and y.shape == x.shape and y.dtype == x.dtype


class _Spy:
    """Records the calls of a module function and passes them on."""

    def __init__(self, monkeypatch, name):
        self.calls = []
        real = getattr(tspmd, name)

        def spy(*args):
            self.calls.append(args)
            return real(*args)

        monkeypatch.setattr(tspmd, name, spy)


def _into_stage(calls, stage, n_stages, m):
    """The tensors of the recorded ``_hop`` calls that fed ``stage``: the
    schedule hops in the order it visits (step, stage) pairs."""
    order = [s for t in range(m + n_stages - 1)
             for s in range(max(0, t - m + 1), min(n_stages, t + 1))
             if s > 0]
    assert len(order) == len(calls)
    return [c[0] for c, s in zip(calls, order) if s == stage]


# ---------------------------------------------------------------------------
# the LM lowering across devices
# ---------------------------------------------------------------------------
def _lm(arch="qwen3-1.7b", stages=4, bf16=False):
    jcfg = jconfigs.get(arch).smoke_config()
    tcfg = tconfigs.get(arch).smoke_config()
    if bf16:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    jparams = jmodels.init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    tpl = tapi.plan(tapi.DeploymentSpec(stages=stages,
                                        strategy="balanced_norefine"),
                    graph=tlm_graph.lm_layer_graph(tcfg, seq_len=SEQ))
    return jcfg, jparams, tcfg, tparams, tpl


def _reference_fp32(jcfg, jparams, tokens, n_blocks=None):
    """The reference executor's numerics without its mesh: fp32
    activations through the first ``n_blocks`` blocks (all: then the
    unembedding too)."""
    x = jlm.embed_tokens(jcfg, jparams, tokens).astype(jnp.float32)
    positions = jnp.arange(tokens.shape[1])[None, :]
    fn = jlm._block_fn(jcfg)
    blocks = jparams["blocks"]
    if n_blocks is not None:
        blocks = jax.tree.map(lambda a: a[:n_blocks], blocks)
    x, _ = jax.lax.scan(lambda x, bp: (fn(x, bp, positions), None), x,
                        blocks)
    return np.asarray(x if n_blocks is not None
                      else jlm.unembed(jcfg, jparams, x))


@pytest.fixture(scope="module", params=["qwen3-1.7b",
                                        "granite-moe-1b-a400m"],
                ids=["dense", "moe"])
def lm_case(request):
    return _lm(request.param)


def test_lm_executor_across_devices(monkeypatch, lm_case):
    """On (cpu, cpu, meta, meta): each stage's weights on its device, the
    hop out of stage 1 equal to the reference's fp32 stage math at that
    cut, microbatch by microbatch, and fp32 logits on ``meta``."""
    jcfg, jparams, tcfg, tparams, tpl = lm_case
    counts = tserve.stage_block_counts(tpl, tcfg.n_layers)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (8, SEQ))
    stages = _Spy(monkeypatch, "_lm_stage")
    hops = _Spy(monkeypatch, "_hop")
    with tspmd.SpmdPipelineExecutor.for_lm(
            tcfg, tparams, tpl, mesh=_mixed_mesh(), n_microbatches=4,
            batch_size=8, seq_len=SEQ) as ex:
        got = ex(torch.from_numpy(tokens))
    assert got.device == META and got.dtype == torch.float32
    assert got.shape == (8, SEQ, tcfg.vocab)
    for s, (_, blocks, positions) in enumerate(stages.calls[:4]):
        assert len(blocks) == counts[s]
        leaves = [t for bp in blocks for t in tspmd.tree_flatten(bp)[0]]
        assert leaves and {t.device for t in leaves} == {MIXED[s]}
        assert {t.dtype for t in leaves} == {torch.float32}
        assert positions.device == MIXED[s]
    out_of_1 = _into_stage(hops.calls, 2, 4, 4)
    assert len(out_of_1) == 4
    assert all(x.device == CPU for x in out_of_1)
    cut = counts[0] + counts[1]
    expect = _reference_fp32(jcfg, jparams, jnp.asarray(tokens, jnp.int32),
                             n_blocks=cut)
    for i, x in enumerate(out_of_1):
        np.testing.assert_allclose(x.numpy(), expect[2 * i:2 * i + 2],
                                   rtol=1e-4, atol=1e-4)
    # the hops within a device hand the same tensor on
    assert [dev for _, _, dev, _ in hops.calls].count(CPU) == 4
    assert [dev for _, _, dev, _ in hops.calls].count(META) == 8


def test_lm_compose_across_devices(lm_case):
    _, _, tcfg, tparams, tpl = lm_case
    tokens = torch.zeros((3, SEQ), dtype=torch.long)
    with tspmd.SpmdPipelineExecutor.for_lm(
            tcfg, tparams, tpl, mesh=_mixed_mesh(), n_microbatches=2) as ex:
        got = ex.compose(tokens)
        assert got.device == META and got.shape == (3, SEQ, tcfg.vocab)
        assert ex.achieved_stage_times(reps=1, warmup=0)[0] > 0


def test_pipeline_logits_across_devices(monkeypatch):
    """The model-dtype entry point: blocks moved to their stages'
    devices, the hop out of stage 1 equal to the one on an all-CPU mesh,
    the logits on the last stage's device."""
    _, _, tcfg, tparams, tpl = _lm(bf16=True)
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(1).integers(0, tcfg.vocab, (4, SEQ)))}
    hops = {}
    for name, mesh in (("cpu", tspmd.default_stage_mesh(4, "cpu")),
                       ("mixed", _mixed_mesh())):
        spy = _Spy(monkeypatch, "_hop")
        got = tspmd.pipeline_logits(tcfg, mesh, tpl, tparams, batch,
                                    n_microbatches=2)
        hops[name] = _into_stage(spy.calls, 2, 4, 2)
        monkeypatch.undo()
    assert got.device == META and got.shape == (4, SEQ, tcfg.vocab)
    assert got.dtype == torch.float32
    assert len(hops["cpu"]) == len(hops["mixed"]) == 2
    for a, b in zip(hops["cpu"], hops["mixed"]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the CNN lowering and the weight streaming across devices
# ---------------------------------------------------------------------------
def test_cnn_executor_across_devices(monkeypatch):
    """The flat boundary buffers cross to ``meta`` as the LM's hidden
    states do: each stage's weight row on its device, the hop out of
    stage 1 equal to the all-CPU mesh's, the output on ``meta``."""
    m = tcnn.synthetic_cnn(8, L=6, hw=32)
    pl = tapi.plan(tapi.DeploymentSpec(stages=4,
                                       strategy="balanced_norefine"),
                   graph=m.to_layer_graph())
    params = m.init(CPU, torch.Generator().manual_seed(0))
    x = torch.randn((8,) + m.input_shape,
                    generator=torch.Generator().manual_seed(1))
    hops, outs = {}, {}
    for name, mesh in (("cpu", tspmd.default_stage_mesh(4, "cpu")),
                       ("mixed", _mixed_mesh())):
        spy = _Spy(monkeypatch, "_hop")
        rows = _Spy(monkeypatch, "_unflatten_stage_params")
        with tspmd.SpmdPipelineExecutor.for_cnn(
                m, params, pl, mesh=mesh, n_microbatches=4) as ex:
            outs[name] = ex(x)
        assert [w.device for w, *_ in rows.calls] == list(mesh.devices)
        hops[name] = _into_stage(spy.calls, 2, 4, 4)
        monkeypatch.undo()
    direct = m.apply(params, x)
    assert outs["mixed"].device == META
    assert outs["mixed"].shape == outs["cpu"].shape == direct.shape
    torch.testing.assert_close(outs["cpu"], direct, rtol=1e-4, atol=1e-4)
    assert len(hops["cpu"]) == len(hops["mixed"]) == 4
    for a, b in zip(hops["cpu"], hops["mixed"]):
        assert torch.equal(a, b)


def test_stream_stage_weights_places_each_stage_on_its_device():
    stages = [{"w": torch.full((4,), float(s)), "b": [torch.ones(2)]}
              for s in range(4)]
    placed, _, rep = tspmd.stream_stage_weights(_mixed_mesh(), stages,
                                                overlap=True)
    for s, tree in enumerate(placed):
        leaves = tspmd.tree_flatten(tree)[0]
        assert {t.device for t in leaves} == {MIXED[s]}
        if MIXED[s] == CPU:
            assert torch.equal(tree["w"], stages[s]["w"])
            assert tree["w"].data_ptr() != stages[s]["w"].data_ptr()
    assert 0 <= rep.blocked_s <= rep.fill_s


# ---------------------------------------------------------------------------
# cards=1: the executors as before, equal to the reference
# ---------------------------------------------------------------------------
def test_cnn_executor_on_a_one_card_mesh_matches_reference():
    jm = jcnn.synthetic_cnn(8, L=6, hw=32)
    tm = tcnn.synthetic_cnn(8, L=6, hw=32)
    spec = dict(stages=4, strategy="balanced_norefine")
    tpl = tapi.plan(tapi.DeploymentSpec(**spec), graph=tm.to_layer_graph())
    jpl = japi.plan(japi.DeploymentSpec(**spec), graph=jm.to_layer_graph())
    assert tpl.cuts == jpl.cuts
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    x = np.random.default_rng(1).standard_normal(
        (7,) + tuple(jm.input_shape)).astype(np.float32)
    expect = np.asarray(jm.apply(jax.tree.map(jnp.asarray, tree),
                                 jnp.asarray(x)))
    params = cnn_params_from_numpy(tree, CPU)
    with tspmd.SpmdPipelineExecutor.for_cnn(
            tm, params, tpl, n_microbatches=4, batch_size=7,
            mesh=tspmd.default_stage_mesh(4, "cpu", cards=1)) as ex:
        got = ex(torch.from_numpy(x))
        composed = ex.compose(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(composed.numpy(), expect, rtol=1e-4,
                               atol=1e-4)


def test_lm_executor_on_a_one_card_mesh_matches_reference(lm_case):
    jcfg, jparams, tcfg, tparams, tpl = lm_case
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab, (7, SEQ))
    expect = _reference_fp32(jcfg, jparams, jnp.asarray(tokens, jnp.int32))
    with tspmd.SpmdPipelineExecutor.for_lm(
            tcfg, tparams, tpl, n_microbatches=4, batch_size=7, seq_len=SEQ,
            mesh=tspmd.default_stage_mesh(4, "cpu", cards=1)) as ex:
        got = ex(torch.from_numpy(tokens))
        composed = ex.compose(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(composed.numpy(), expect, rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the front doors
# ---------------------------------------------------------------------------
def test_front_door_takes_the_mesh_unchanged(monkeypatch):
    m = tcnn.synthetic_cnn(4, L=5, hw=16)
    params = m.init(CPU, torch.Generator().manual_seed(0))
    dep = tserve.deploy_cnn(m, params, tapi.DeploymentSpec(
        stages=4, strategy="balanced_norefine", backend="spmd"), CPU)
    mesh = _mixed_mesh()
    with dep.executor(model=m, params=params, mesh=mesh,
                      n_microbatches=2) as ex:
        assert ex.mesh is mesh
        assert ex(torch.zeros((2,) + m.input_shape)).device == META


def test_serve_cli_cards_one_on_the_cpu():
    res = tserve.main(["--smoke", "--device", "cpu", "--backend", "spmd",
                       "--stages", "2", "--cards", "1", "--requests", "2",
                       "--seq", "16", "--microbatch", "2",
                       "--plan-device-bytes", "80000000000"])
    assert res["max_err"] < 2e-2
    assert res["cards"] == ["cpu", "cpu"] and res["peer_access"] == {}


@pytest.mark.parametrize("argv,match", [
    (["--backend", "spmd", "--cards", "2"], "needs CUDA devices"),
    (["--cards", "2"], "needs --backend spmd"),
    (["--backend", "spmd", "--workload", "decode", "--cards", "2"],
     "needs --backend spmd and the batch workload"),
], ids=["cpu", "host_backend", "decode"])
def test_serve_cli_refuses_cards_it_cannot_use(argv, match):
    with pytest.raises((SystemExit, ValueError), match=match):
        tserve.main(["--smoke", "--device", "cpu", "--stages", "2",
                     "--requests", "2", "--seq", "16", *argv])


def test_init_params_kept_on_another_device_has_the_same_numbers():
    """``keep_on`` moves each piece once made: the same numbers as the
    model made where the generator lives (here both on the CPU; on a card
    the model is made there and kept on the host)."""
    cfg = tconfigs.get("granite-moe-1b-a400m").smoke_config()
    a = tserve.lm.init_params(cfg, CPU, torch.Generator().manual_seed(3))
    b = tserve.lm.init_params(cfg, CPU, torch.Generator().manual_seed(3),
                              keep_on=META)
    la, lb = tspmd.tree_flatten(a)[0], tspmd.tree_flatten(b)[0]
    assert len(la) == len(lb)
    assert all(y.device == META and y.shape == x.shape
               and y.dtype == x.dtype for x, y in zip(la, lb))
    c = tserve.lm.init_params(cfg, CPU, torch.Generator().manual_seed(3),
                              keep_on=CPU)
    assert all(torch.equal(x, y)
               for x, y in zip(la, tspmd.tree_flatten(c)[0]))


# ---------------------------------------------------------------------------
# launches counted by card
# ---------------------------------------------------------------------------
def test_launches_are_counted_by_card():
    _build.reset_launches()
    try:
        for dev in ("cuda:1", "cuda:1", "cuda:0", "cuda:3"):
            _build.count_launch("flash_attention", torch.device(dev))
        _build.count_launch("flash_attention")
        _build.count_launch("flash_decode", torch.device("cuda:2"))
        assert _build.launches("flash_attention") == 5
        assert _build.launches_by_card("flash_attention") == {0: 1, 1: 2,
                                                              3: 1}
        assert _build.launches_by_card("flash_decode") == {2: 1}
        assert _build.launches_by_card("rglru_scan") == {}
    finally:
        _build.reset_launches()
    assert _build.launches_by_card("flash_attention") == {}
