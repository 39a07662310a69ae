"""The port's whisper (encdec family) against the JAX reference.

The reference's whisper smoke config (2 encoder and 2 decoder layers, 12
frames, d_model 64) with its init from seed 0, carried across by
``params_from_numpy``; inputs from numpy seeds.  The reference's whisper
calls no Pallas kernel (its attention is plain jnp); the port's runs
through the flash kernels' plain versions on the CPU.

Tolerances: fp32 within 1e-4 (summation order, elementwise as
``assert_allclose``); bf16 the largest deviation within 2e-2 of the
logits' scale, max(1, max |reference|), as
``tests/test_torch_lm_families.py`` (the two packages round bf16 at
different points).  Graphs and plans are equal exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as jfront
from repro import configs as jconfigs
from repro.core.edge_tpu_model import EdgeTPUSpec as JEdgeTPUSpec
from repro.decode import engine as jengine
from repro.decode import placement as jplacement
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import attention as JA
from repro.models import lm_graph as jlm_graph
from repro.models import whisper as jwhisper
from repro_torch import api as tfront
from repro_torch import configs as tconfigs
from repro_torch.decode import engine as tengine
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import attention as TA
from repro_torch.models import lm_graph as tlm_graph
from repro_torch.models import whisper as twhisper
from repro_torch.models.convert import params_from_numpy

ARCH = "whisper-tiny"
CPU = torch.device("cpu")
DTYPES = ["float32", "bfloat16"]
SEQ = 9             # decoder tokens of the forward (the smoke memory: 12)
STEPS = 8           # decode steps


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _assert_close(got, expect, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)
    else:
        err = np.abs(got - expect).max()
        assert err <= 2e-2 * max(1.0, np.abs(expect).max()), err


@functools.lru_cache(maxsize=None)
def _weights(dtype="float32"):
    """Both packages' smoke configs in ``dtype``, the reference's params
    (jnp) and the port's (converted), seed 0."""
    jcfg = dataclasses.replace(jconfigs.get(ARCH).smoke_config(),
                               dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(tconfigs.get(ARCH).smoke_config(),
                               dtype=getattr(torch, dtype))
    tree = jax.tree.map(np.asarray, japi.init(jcfg, jax.random.PRNGKey(0)))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tcfg, tree, device="cpu"))


def _inputs(cfg, seed, b=2, seq=SEQ):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, cfg.n_frames, cfg.d_model),
                                 dtype=np.float32)
    tokens = rng.integers(0, cfg.vocab, (b, seq)).astype(np.int32)
    return frames, tokens


def _jbatch(frames, tokens):
    return {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)}


def _tbatch(frames, tokens):
    return {"frames": torch.from_numpy(frames),
            "tokens": torch.from_numpy(tokens.astype(np.int64))}


# ---------------------------------------------------------------- configs --

def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(d["dtype"]).split(".")[-1].replace("'>", "")
    return d


def test_configs_match_reference():
    for which in ("config", "smoke_config"):
        j = getattr(jconfigs.get(ARCH), which)()
        t = getattr(tconfigs.get(ARCH), which)()
        assert _fields(t) == _fields(j), which
    smoke = tconfigs.get(ARCH).smoke_config()
    assert (smoke.n_enc_layers, smoke.n_layers, smoke.n_frames,
            smoke.n_kv_heads) == (2, 2, 12, 4)


def test_param_count_matches_reference():
    jcfg, tcfg = jconfigs.get(ARCH).config(), tconfigs.get(ARCH).config()
    assert tapi.param_count(tcfg) == japi.param_count(jcfg)
    assert tapi.active_param_count(tcfg) == japi.active_param_count(jcfg)


def test_params_from_numpy_splits_the_encoder_and_decoder_stacks():
    _, tcfg, jp, params = _weights()
    assert len(params["enc"]) == tcfg.n_enc_layers
    assert len(params["dec"]) == tcfg.n_layers
    assert set(params["dec"][1]) == {"ln1", "attn", "ln_x", "xattn", "ln2",
                                     "mlp"}
    assert "bk" not in params["dec"][1]["xattn"]
    np.testing.assert_array_equal(params["dec"][1]["xattn"]["wv"].numpy(),
                                  np.asarray(jp["dec"]["xattn"]["wv"][1]))
    # the port's own init has the converted tree's shapes and dtypes
    meta = tapi.init(tcfg, torch.device("meta"))
    shapes = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), params)
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), meta) == shapes


def test_concrete_batch_holds_frames():
    cfg = tconfigs.get(ARCH).smoke_config()
    batch = tconfigs.concrete_batch(cfg, 7, 3, kind="prefill")
    assert batch["frames"].shape == (3, cfg.n_frames, cfg.d_model)
    assert batch["frames"].dtype == cfg.dtype
    assert batch["tokens"].shape == (3, 7)


# ------------------------------------------------------------- primitives --

@pytest.mark.parametrize("s,t", [(5, 12), (17, 12)], ids=["s_lt_t",
                                                        "s_gt_t"])
def test_cross_attention_matches_reference(s, t):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, s, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, t, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, t, 2, 16)).astype(np.float32)
    got = TA.cross_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    expect = JA.cross_attention(*(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(_np32(got), np.asarray(expect), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------------ models --

@pytest.mark.parametrize("last", [False, True], ids=["full", "last_token"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_reference(dtype, last):
    jcfg, tcfg, jp, params = _weights(dtype)
    frames, tokens = _inputs(tcfg, seed=3)
    expect = japi.forward(jcfg, jp, _jbatch(frames, tokens),
                          last_token_only=last)
    got = tapi.forward(tcfg, params, _tbatch(frames, tokens),
                       last_token_only=last)
    assert got.shape == expect.shape == (2, 1 if last else SEQ, tcfg.vocab)
    assert got.dtype == torch.float32
    _assert_close(_np32(got), np.asarray(expect), dtype)


def test_forward_hidden_and_unembed_match_reference():
    jcfg, tcfg, jp, params = _weights()
    frames, tokens = _inputs(tcfg, seed=4)
    jh = japi.forward_hidden(jcfg, jp, _jbatch(frames, tokens))
    th = tapi.forward_hidden(tcfg, params, _tbatch(frames, tokens))
    np.testing.assert_allclose(_np32(th), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        _np32(tapi.unembed(tcfg, params, th)),
        np.asarray(japi.unembed(jcfg, jp, jh)), rtol=1e-4, atol=1e-4)


def test_encode_matches_reference():
    jcfg, tcfg, jp, params = _weights()
    frames, _ = _inputs(tcfg, seed=5)
    np.testing.assert_allclose(
        _np32(twhisper.encode(tcfg, params, torch.from_numpy(frames))),
        np.asarray(jwhisper.encode(jcfg, jp, jnp.asarray(frames))),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("with_memory", [True, False],
                         ids=["memory", "zeros"])
def test_init_cache_matches_reference(with_memory):
    jcfg, tcfg, jp, params = _weights()
    frames, _ = _inputs(tcfg, seed=6)
    if with_memory:
        jc = jwhisper.init_cache(
            jcfg, 2, 16, jwhisper.encode(jcfg, jp, jnp.asarray(frames)), jp)
        tc = twhisper.init_cache(
            tcfg, 2, 16, CPU,
            twhisper.encode(tcfg, params, torch.from_numpy(frames)), params)
    else:
        jc = japi.init_cache(jcfg, 2, 16)
        tc = tapi.init_cache(tcfg, 2, 16, CPU)
        assert not tc["mem_k"].any() and not tc["mem_v"].any()
    assert set(tc) == set(jc) and tc["len"] == int(jc["len"]) == 0
    for key in ("k", "v", "mem_k", "mem_v"):
        assert tuple(tc[key].shape) == jc[key].shape, key
        np.testing.assert_allclose(_np32(tc[key]), np.asarray(jc[key]),
                                   rtol=1e-4, atol=1e-4)
    assert tc["mem_k"].shape == (tcfg.n_layers, 2, tcfg.n_frames,
                                 tcfg.n_kv_heads, tcfg.hd)


@functools.lru_cache(maxsize=None)
def _jit_decode(jcfg):
    return jax.jit(lambda p, t, c: jwhisper.forward_decode(jcfg, p, t, c))


def _decode_loop(dtype, memory=True):
    """The same tokens fed one a step through both packages' decode from a
    cache built from the encoder's memory of the same frames (``memory``)
    or the API's all-zero memory: (port, reference) logits (B, STEPS,
    V)."""
    jcfg, tcfg, jp, params = _weights(dtype)
    frames, toks = _inputs(tcfg, seed=7, seq=STEPS)
    if memory:
        jc = jwhisper.init_cache(
            jcfg, 2, STEPS + 2,
            jwhisper.encode(jcfg, jp, jnp.asarray(frames)), jp)
        tc = twhisper.init_cache(
            tcfg, 2, STEPS + 2, CPU,
            twhisper.encode(tcfg, params, torch.from_numpy(frames)), params)
    else:
        jc = japi.init_cache(jcfg, 2, STEPS + 2)
        tc = tapi.init_cache(tcfg, 2, STEPS + 2, CPU)
    step = _jit_decode(jcfg)
    got, expect = [], []
    for i in range(STEPS):
        lj, jc = step(jp, jnp.asarray(toks[:, i:i + 1]), jc)
        lt, tc = tapi.decode(tcfg, params,
                             torch.from_numpy(toks[:, i:i + 1]).long(), tc)
        assert tc["len"] == i + 1
        expect.append(np.asarray(lj))
        got.append(_np32(lt))
    return np.concatenate(got, 1), np.concatenate(expect, 1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_loop_matches_reference(dtype):
    """Every step's logits, from a cache built from the memory."""
    got, expect = _decode_loop(dtype)
    assert got.shape == (2, STEPS, 512)
    _assert_close(got, expect, dtype)


def test_api_decode_attends_the_zero_memory_as_the_reference():
    """``api.init_cache`` passes no memory (the reference's ``api``): a
    decode through the bare API attends an all-zero memory, in both."""
    got, expect = _decode_loop("float32", memory=False)
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)
    with_memory, _ = _decode_loop("float32")
    assert np.abs(got - with_memory).max() > 1e-3


def test_decode_loop_equals_decode_train():
    """The port's decode steps against its own teacher-forced pass over
    the same tokens and memory, at every position."""
    _, tcfg, _, params = _weights()
    frames, toks = _inputs(tcfg, seed=8, seq=STEPS)
    memory = twhisper.encode(tcfg, params, torch.from_numpy(frames))
    tokens = torch.from_numpy(toks.astype(np.int64))
    full = twhisper.decode_train(tcfg, params, tokens, memory)
    cache = twhisper.init_cache(tcfg, 2, STEPS, CPU, memory, params)
    rows = []
    for i in range(STEPS):
        logits, cache = twhisper.forward_decode(tcfg, params,
                                                tokens[:, i:i + 1], cache)
        rows.append(logits)
    np.testing.assert_allclose(_np32(torch.cat(rows, 1)), _np32(full),
                               rtol=1e-4, atol=1e-4)
    last = twhisper.decode_train(tcfg, params, tokens, memory,
                                 last_token_only=True)
    np.testing.assert_allclose(_np32(last), _np32(full[:, -1:]), rtol=1e-5,
                               atol=1e-5)


def test_prefill_is_for_the_attention_families():
    _, tcfg, _, params = _weights()
    frames, tokens = _inputs(tcfg, seed=9)
    with pytest.raises(ValueError, match="attention families"):
        tapi.prefill(tcfg, params, _tbatch(frames, tokens),
                     tapi.init_cache(tcfg, 2, 16, CPU))


# -------------------------------------------------------- graph and plans --

def _nodes(g):
    return [(n.name, n.params, n.macs, n.out_bytes, n.weight_bytes, n.kind,
             tuple(g.predecessors(n.name))) for n in g.nodes.values()]


@pytest.mark.parametrize("which,seq", [("config", 448),
                                       ("smoke_config", 16)],
                         ids=["full", "smoke"])
def test_lm_graph_matches_reference(which, seq):
    jg = jlm_graph.lm_layer_graph(getattr(jconfigs.get(ARCH), which)(),
                                  seq_len=seq)
    tg = tlm_graph.lm_layer_graph(getattr(tconfigs.get(ARCH), which)(),
                                  seq_len=seq)
    assert _nodes(tg) == _nodes(jg)
    assert tg.levels() == jg.levels() and tg.depth == jg.depth
    # paper §6.1.1: every decoder layer lies deeper than the encoder
    levels = tg.levels()
    depth = {n: i for i, lvl in enumerate(levels) for n in lvl}
    n_enc = getattr(tconfigs.get(ARCH), which)().n_enc_layers
    assert min(d for n, d in depth.items() if n.startswith("dec_")) > \
        depth[f"enc_{n_enc - 1}"]


@pytest.mark.parametrize("workload", ["batch", "decode"])
def test_serve_cli_plan_matches_reference(monkeypatch, capsys, workload):
    """``--arch whisper-tiny`` plans, prints the plan, the report and the
    reference's note, and serves nothing; its plan equals the reference's
    front door on the same full-width graph (decode: priced for the full
    config on a device of ``--plan-device-bytes``)."""
    argv = ["--arch", ARCH, "--device", "cpu", "--workload", workload,
            "--stages", "2", "--seq", "64"]
    if workload == "decode":
        argv += ["--plan-device-bytes", str(2 ** 30)]
    res = tserve.main(argv)
    out = capsys.readouterr().out
    assert "plan: whisper-tiny" in out and "report:" in out
    assert "note: family 'encdec' (whisper-tiny)" in out
    args = tserve.parse_args(argv)
    jfull = jconfigs.get(ARCH).config()
    graph = jlm_graph.lm_layer_graph(jfull, seq_len=64)
    if workload == "decode":
        monkeypatch.setattr(jplacement, "decode_config_for",
                            lambda _: jfull)
        jpl = jfront.plan(jserve.spec_from_args(args), graph=graph,
                          base_spec=JEdgeTPUSpec(onchip_bytes=2 ** 30))
        assert res["plan"].decode_info == jpl.decode_info
    else:
        jpl = jfront.plan(jserve.spec_from_args(args), graph=graph)
    tpl = res["plan"]
    assert tpl.cuts == jpl.cuts and tpl.stage_layers == jpl.stage_layers
    assert tpl.report.to_dict() == jpl.report.to_dict()


def test_smoke_plans_equal_reference():
    spec = dict(model=f"lm:{ARCH}:seq=16", stages=3, strategy="balanced")
    jpl = jfront.plan(jfront.DeploymentSpec(**spec))
    tpl = tfront.plan(tfront.DeploymentSpec(**spec))
    assert tpl.cuts == jpl.cuts and tpl.stage_layers == jpl.stage_layers
    assert tpl.report.to_dict() == jpl.report.to_dict()


def test_decode_server_raises_the_reference_error():
    spec = dict(model=f"lm:{ARCH}", workload="decode", stages=2,
                strategy="decode_placement", max_context=64,
                decode_concurrency=2)
    with pytest.raises(ValueError) as jerr:
        jengine.build_decode_server(jfront.DeploymentSpec(**spec))
    with pytest.raises(ValueError) as terr:
        tengine.build_decode_server(tfront.DeploymentSpec(**spec))
    assert str(terr.value) == str(jerr.value)
    _, tcfg, _, params = _weights()
    with pytest.raises(ValueError, match="family='encdec'"):
        tengine.PipelineDecodeEngine(tcfg, params, n_slots=2,
                                     max_context=16)
