"""The port's recurrentgemma (hybrid family) and its RG-LRU scan against
the JAX package.

Same numpy inputs and the reference's weights (its init, converted with
``params_from_numpy``), fp32.  Tolerances:

* the plain ``rglru_scan`` (the CPU side of the kernel's wrapper) against
  the reference's oracle and its Pallas kernel in interpret mode: 1e-5, as
  ``tests/test_kernels.py`` holds the Pallas kernel to the oracle; against
  the recurrence written out in numpy: 2e-5;
* model pieces and plain windowed attention: 1e-5 (fp32 arithmetic in
  another order);
* the smoke forward (S up to and above the smoke window of 16) and the
  decode loop (24 tokens, past the window, so the ring cache wraps):
  1e-4, greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as jfront
from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru_scan as jrglru_pallas
from repro.models import api as japi
from repro.models import attention as JA
from repro.models import lm as jlm
from repro.models import lm_graph as jlm_graph
from repro.models import rglru as jrglru
from repro_torch import api as tfront
from repro_torch import configs as tconfigs
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import attention as TA
from repro_torch.models import lm as tlm
from repro_torch.models import lm_graph as tlm_graph
from repro_torch.models import rglru as trglru
from repro_torch.models.convert import params_from_numpy

ARCH = "recurrentgemma-9b"
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _scan_inputs(rng, b, s, r, lo=0.3):
    return (rng.uniform(lo, 1.0, (b, s, r)).astype(np.float32),
            (rng.normal(size=(b, s, r)) * 0.2).astype(np.float32),
            rng.normal(size=(b, r)).astype(np.float32))


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,s,r,chunk", [
    (1, 128, 128, 64), (2, 256, 256, 128), (2, 512, 128, 512),
    (1, 256, 128, 256),
])
def test_scan_matches_oracle_and_pallas_interpret(b, s, r, chunk):
    x = _scan_inputs(np.random.default_rng(42), b, s, r)
    y, h = rglru_scan(*map(_t, x))
    jx = tuple(map(jnp.asarray, x))
    for yr, hr in (jref.rglru_scan_ref(*jx),
                   jrglru_pallas(*jx, chunk=chunk, interpret=True)):
        np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(h.numpy(), np.asarray(hr), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("seed,b,s", [(0, 1, 1), (1, 2, 32), (2, 3, 97),
                                      (3, 2, 128)])
def test_scan_is_the_recurrence(seed, b, s):
    """The plain scan equals the recurrence written out in numpy, for any
    S (no chunk divisibility)."""
    a, g, h0 = _scan_inputs(np.random.default_rng(seed), b, s, 8, lo=0.0)
    y, h = rglru_scan(*map(_t, (a, g, h0)))
    href = h0.copy()
    ys = np.empty_like(a)
    for t in range(s):
        href = a[:, t] * href + g[:, t]
        ys[:, t] = href
    np.testing.assert_allclose(y.numpy(), ys, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(h.numpy(), href, rtol=2e-5, atol=2e-5)


def test_carry_across_a_split_sequence():
    a, g, h0 = map(_t, _scan_inputs(np.random.default_rng(5), 2, 64, 16))
    y1, h1 = rglru_scan(a, g, h0)
    ya, ha = rglru_scan(a[:, :40], g[:, :40], h0)
    yb, hb = rglru_scan(a[:, 40:], g[:, 40:], ha)
    torch.testing.assert_close(torch.cat([ya, yb], 1), y1, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(hb, h1, rtol=1e-5, atol=1e-5)


def test_scan_keeps_dtype_and_rejects_bad_inputs():
    a, g, h0 = map(_t, _scan_inputs(np.random.default_rng(6), 2, 5, 8))
    y, h = rglru_scan(a.bfloat16(), g.bfloat16(), h0)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    for bad in ((a, g[:, :4], h0), (a, g, h0[:, :4]), (a, g.double(), h0),
                (a[:, :0], g[:, :0], h0)):
        with pytest.raises((ValueError, TypeError)):
            rglru_scan(*bad)


# ---------------------------------------------------------------------------
# plain attention pieces of the hybrid's local-attention layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,window,q_offset", [(24, 8, 0), (8, 5, 16)])
def test_windowed_full_attention_matches_reference(s, window, q_offset):
    rng = np.random.default_rng(s)
    q = rng.normal(size=(2, s, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, s + q_offset, 1, 16)).astype(np.float32)
            for _ in range(2))
    np.testing.assert_allclose(
        TA.full_attention(*map(_t, (q, k, v)), q_offset=q_offset,
                          window=window).numpy(),
        np.asarray(JA.full_attention(*map(jnp.asarray, (q, k, v)),
                                     q_offset=q_offset, window=window)),
        rtol=1e-5, atol=1e-5)


def test_windowed_decode_attention_matches_reference():
    rng = np.random.default_rng(9)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 40, 1, 16)).astype(np.float32)
            for _ in range(2))
    np.testing.assert_allclose(
        TA.decode_attention(*map(_t, (q, k, v)), 30, window=12).numpy(),
        np.asarray(JA.decode_attention(*map(jnp.asarray, (q, k, v)),
                                       jnp.asarray(30), window=12)),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    """fp32 smoke configs of both packages and one set of weights."""
    jcfg = jconfigs.get(ARCH).smoke_config()
    tcfg = tconfigs.get(ARCH).smoke_config()
    jparams = japi.init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab,
                                                (b, s)).astype(np.int32)


def _rec(jparams, tparams):
    """The second tail rec block of both trees."""
    return (jax.tree.map(lambda a: a[1], jparams["tail"]),
            tparams["tail"][1])


def test_converted_tree_matches_the_layer_pattern(weights):
    jcfg, tcfg, jparams, tparams = weights
    n_super, tail = trglru.n_super_and_tail(tcfg.n_layers, tcfg.attn_every)
    assert (n_super, tail) == (1, 2)
    assert trglru.n_super_and_tail(38, 3) == (12, 2)
    assert len(tparams["super"]) == n_super and len(tparams["tail"]) == tail
    assert set(tparams["super"][0]) == {"rec1", "rec2", "attn"}
    np.testing.assert_array_equal(
        tparams["tail"][1]["rec"]["conv_w"].numpy(),
        np.asarray(jparams["tail"]["rec"]["conv_w"][1]))


def test_geglu_mlp_matches_reference(weights):
    jcfg, tcfg, jparams, tparams = weights
    x = np.random.default_rng(1).normal(size=(2, 5, 64)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["super"]["attn"]["mlp"])
    np.testing.assert_allclose(
        tlm.mlp_block(tcfg, tparams["super"][0]["attn"]["mlp"],
                      _t(x)).numpy(),
        np.asarray(jlm.mlp_block(jcfg, jp, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_carry", [False, True])
def test_causal_conv_matches_reference(weights, with_carry):
    jcfg, tcfg, jparams, tparams = weights
    jrec, trec = _rec(jparams, tparams)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    carry = (rng.normal(size=(2, 3, 64)).astype(np.float32)
             if with_carry else None)
    jy, jc = jrglru._causal_conv(jrec["rec"], jnp.asarray(x),
                                 None if carry is None else jnp.asarray(carry))
    ty, tc = trglru._causal_conv(trec["rec"], _t(x),
                                 None if carry is None else _t(carry))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_rg_lru_and_rec_temporal_match_reference(weights):
    jcfg, tcfg, jparams, tparams = weights
    jrec, trec = _rec(jparams, tparams)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    h0 = rng.normal(size=(2, 64)).astype(np.float32)
    for a, b in zip(trglru.rg_lru(trec["rec"], _t(x), _t(h0)),
                    jrglru.rg_lru(jrec["rec"], jnp.asarray(x),
                                  jnp.asarray(h0))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    state = {"conv": rng.normal(size=(2, 3, 64)).astype(np.float32),
             "h": h0}
    jout, jst = jrglru.rec_temporal(jcfg, jrec["rec"], jnp.asarray(x),
                                    jax.tree.map(jnp.asarray, state))
    tout, tst = trglru.rec_temporal(tcfg, trec["rec"], _t(x),
                                    {k: _t(v) for k, v in state.items()})
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    for key in ("conv", "h"):
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seq", [7, 16])
def test_forward_matches_reference(weights, seq):
    jcfg, tcfg, jparams, tparams = weights
    tokens = _tokens(tcfg, 2, seq, seq)
    expect = japi.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    got = tapi.forward(tcfg, tparams, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, seq, tcfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-4,
                               atol=1e-4)


def test_hidden_and_unembed_compose_to_forward(weights):
    _, tcfg, _, tparams = weights
    batch = {"tokens": torch.from_numpy(_tokens(tcfg, 2, 9, 1))}
    hidden = tapi.forward_hidden(tcfg, tparams, batch)
    torch.testing.assert_close(tapi.unembed(tcfg, tparams, hidden),
                               tapi.forward(tcfg, tparams, batch))


def test_prompt_above_the_window_raises(weights):
    """A prompt one token above the window no longer raises: the flash
    kernel's plain version masks the keys outside the window, and the
    forward equals the reference's (1e-4, as the smoke forward)."""
    jcfg, tcfg, jparams, tparams = weights
    tokens = _tokens(tcfg, 1, tcfg.local_window + 1, 0)
    expect = japi.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    got = tapi.forward(tcfg, tparams, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-4,
                               atol=1e-4)


def test_decode_loop_wraps_the_ring_like_the_reference(weights):
    """8 prompt tokens fed token by token, then 16 greedy steps: 24 tokens
    through a ring cache of the smoke window's 16 rows."""
    jcfg, tcfg, jparams, tparams = weights
    prompt = _tokens(tcfg, 2, 8, 4)
    jcache = japi.init_cache(jcfg, 2, 24)
    tcache = tapi.init_cache(tcfg, 2, 24, CPU)
    assert tcache["k"].shape == tuple(jcache["k"].shape) == (1, 2, 16, 1, 16)
    jtok = ttok = None
    jtoks, ttoks = [], []
    for i in range(24):
        jin = prompt[:, i:i + 1] if i < 8 else jtok
        tin = torch.from_numpy(prompt[:, i:i + 1]) if i < 8 else ttok
        jl, jcache = japi.decode(jcfg, jparams, jnp.asarray(jin), jcache)
        tl, tcache = tapi.decode(tcfg, tparams, tin, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        jtok = np.asarray(jl[:, -1].argmax(-1))[:, None]
        ttok = tl[:, -1].argmax(-1, keepdim=True)
        jtoks.append(jtok)
        ttoks.append(ttok.numpy())
    np.testing.assert_array_equal(np.concatenate(ttoks, 1),
                                  np.concatenate(jtoks, 1))
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=1e-4, atol=1e-4)
    assert tcache["len"] == int(jcache["len"]) == 24


def test_decode_matches_forward_inside_the_window(weights):
    _, tcfg, _, tparams = weights
    tokens = torch.from_numpy(_tokens(tcfg, 2, 12, 3))
    cache = tapi.init_cache(tcfg, 2, 16, CPU)
    for i in range(12):
        logits, cache = tapi.decode(tcfg, tparams, tokens[:, i:i + 1], cache)
    torch.testing.assert_close(
        logits, tapi.forward(tcfg, tparams, {"tokens": tokens},
                             last_token_only=True), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# graph, plans, CLI
# ---------------------------------------------------------------------------
def _nodes(g):
    return [(n.name, n.params, n.macs, n.out_bytes, n.weight_bytes, n.kind,
             tuple(g.predecessors(n.name))) for n in g.nodes.values()]


@pytest.mark.parametrize("which,seq", [("config", 64), ("config", 4096),
                                       ("smoke_config", 64)])
def test_layer_graph_equals_reference(which, seq):
    jg = jlm_graph.lm_layer_graph(getattr(jconfigs.get(ARCH), which)(), seq)
    tg = tlm_graph.lm_layer_graph(getattr(tconfigs.get(ARCH), which)(), seq)
    assert _nodes(tg) == _nodes(jg)
    assert tg.depth == jg.depth


def test_param_count_equals_reference():
    cfg = tconfigs.get(ARCH).config()
    assert tapi.param_count(cfg) == 8_524_206_080
    assert japi.param_count(jconfigs.get(ARCH).config()) == 8_524_206_080
    params = tapi.init(cfg, "meta")
    assert "head" not in params                      # tied embeddings
    assert len(params["super"]) == 12 and len(params["tail"]) == 2


@pytest.mark.parametrize("spec", [
    dict(stages=4, strategy="balanced"),
    dict(stages=2, strategy="decode_placement", workload="decode",
         max_context=128, decode_concurrency=4),
    dict(stages=None, strategy="decode_placement", workload="decode",
         max_context=2048, decode_concurrency=8),
], ids=["balanced", "decode_placement", "decode_placement_auto"])
def test_smoke_plans_equal_reference(spec):
    model = f"lm:{ARCH}:seq=64"
    jpl = jfront.plan(jfront.DeploymentSpec(model=model, **spec))
    tpl = tfront.plan(tfront.DeploymentSpec(model=model, **spec))
    assert tpl.cuts == jpl.cuts
    assert tpl.stage_layers == jpl.stage_layers
    assert tpl.report.to_dict() == jpl.report.to_dict()


@pytest.mark.parametrize("workload", ["batch", "decode"])
def test_serve_cli_plans_and_notes(capsys, workload):
    res = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--workload", workload, "--stages", "2"])
    out = capsys.readouterr().out
    assert "plan: recurrentgemma-9b-smoke" in out and "report:" in out
    assert "note: family 'hybrid' (recurrentgemma-9b)" in out
    assert res["plan"].stage_layers


def test_serve_cli_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", ARCH, "--smoke"])


def test_dense_module_refuses_the_hybrid_config(weights):
    _, tcfg, _, _ = weights
    with pytest.raises(ValueError, match="repro_torch.models.api"):
        tlm.init_params(tcfg, CPU)
    with pytest.raises(NotImplementedError):
        tapi.init(dataclasses.replace(tcfg, family="moe", n_experts=4,
                                      top_k=2), "cpu")
