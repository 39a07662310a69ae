"""The port's rwkv6 (ssm family) and its WKV scan against the JAX package.

Same numpy inputs and the reference's weights (its init, converted with
``params_from_numpy``), fp32.  Tolerances:

* the plain ``rwkv6_scan`` (the CPU side of the kernel's wrapper) against
  the reference's oracle and its Pallas kernel in interpret mode: 2e-4, as
  ``tests/test_kernels.py`` holds the Pallas kernel to the oracle; the
  carry across a split sequence: 1e-5;
* model pieces: 1e-5 (fp32 matmuls summed in another order);
* the smoke forward: 2e-3 against the reference's default chunked WKV (its
  own tolerance between its two WKV forms, ``tests/test_perf_variants``),
  1e-4 against its per-token scan (``REPRO_VARIANT=rwkv_scan``; S a
  multiple of 64 or at most 64, so its chunking does not change form);
* the decode loop: 1e-4 on every step's logits, greedy tokens equal.
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
from repro.kernels.rwkv6_scan import rwkv6_scan as jrwkv6_pallas
from repro.models import api as japi
from repro.models import attention as JA
from repro.models import lm_graph as jlm_graph
from repro.models import rwkv6 as jrwkv6
from repro_torch import api as tfront
from repro_torch import configs as tconfigs
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import attention as TA
from repro_torch.models import lm_graph as tlm_graph
from repro_torch.models import rwkv6 as trwkv6
from repro_torch.models.convert import params_from_numpy

ARCH = "rwkv6-1.6b"
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _scan_inputs(rng, b, h, s, d):
    return (rng.normal(size=(b, h, s, d)).astype(np.float32),
            (rng.normal(size=(b, h, s, d)) * 0.2).astype(np.float32),
            rng.normal(size=(b, h, s, d)).astype(np.float32),
            rng.uniform(0.7, 1.0, (b, h, s, d)).astype(np.float32),
            (rng.normal(size=(h, d)) * 0.2).astype(np.float32),
            (rng.normal(size=(b, h, d, d)) * 0.1).astype(np.float32))


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,h,s,d,chunk", [
    (1, 1, 128, 64, 64), (2, 2, 128, 64, 128), (1, 2, 256, 32, 64),
])
def test_scan_matches_oracle_and_pallas_interpret(b, h, s, d, chunk):
    x = _scan_inputs(np.random.default_rng(42), b, h, s, d)
    y, s_last = rwkv6_scan(*map(_t, x))
    jx = tuple(map(jnp.asarray, x))
    for yr, sr in (jref.rwkv6_scan_ref(*jx),
                   jrwkv6_pallas(*jx, chunk=chunk, interpret=True)):
        np.testing.assert_allclose(y.numpy(), np.asarray(yr),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(s_last.numpy(), np.asarray(sr),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("s", [1, 31])
@pytest.mark.parametrize("decay", ["tiny", "one", "both"])
def test_scan_at_extreme_decays_matches_pallas_interpret(s, decay):
    """Decays of 1e-30 and 1.0, the ends the kernel must take (it keeps the
    step recurrence, exact for any w), at the decode step S = 1 and a
    ragged S = 31, against the oracle and the Pallas kernel."""
    r, k, v, w, u, s0 = _scan_inputs(np.random.default_rng(11), 2, 2, s, 16)
    if decay == "tiny":
        w[:] = 1e-30
    elif decay == "one":
        w[:] = 1.0
    else:                     # alternate steps and channels
        w[:] = 1.0
        w[:, :, 0::2, 0::2] = 1e-30
        w[:, :, 1::2, 1::2] = 1e-30
    y, s_last = rwkv6_scan(*map(_t, (r, k, v, w, u, s0)))
    jx = tuple(map(jnp.asarray, (r, k, v, w, u, s0)))
    for yr, sr in (jref.rwkv6_scan_ref(*jx),
                   jrwkv6_pallas(*jx, chunk=s, interpret=True)):
        np.testing.assert_allclose(y.numpy(), np.asarray(yr),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(s_last.numpy(), np.asarray(sr),
                                   rtol=2e-4, atol=2e-4)


def test_state_carries_across_a_split_sequence():
    """Half the sequence, then the other half from its state, equals one
    pass (the kernel's S = 1 decode step relies on it)."""
    r, k, v, w, u, _ = map(_t, _scan_inputs(np.random.default_rng(7),
                                           1, 1, 64, 16))
    s0 = torch.zeros(1, 1, 16, 16)
    y1, st1 = rwkv6_scan(r, k, v, w, u, s0)
    ya, sta = rwkv6_scan(r[:, :, :32], k[:, :, :32], v[:, :, :32],
                         w[:, :, :32], u, s0)
    yb, stb = rwkv6_scan(r[:, :, 32:], k[:, :, 32:], v[:, :, 32:],
                         w[:, :, 32:], u, sta)
    torch.testing.assert_close(torch.cat([ya, yb], 2), y1,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(stb, st1, rtol=1e-5, atol=1e-5)
    jy, jst = jrwkv6_pallas(*(jnp.asarray(t.numpy())
                              for t in (r, k, v, w, u, s0)),
                            chunk=32, interpret=True)
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("seed,b,h,s,d", [(0, 1, 1, 1, 16), (1, 2, 3, 33, 16),
                                          (2, 3, 2, 70, 32)])
def test_scan_is_the_recurrence(seed, b, h, s, d):
    """The plain scan equals the recurrence written out in numpy, for any
    S (no chunk divisibility)."""
    r, k, v, w, u, s0 = _scan_inputs(np.random.default_rng(seed), b, h, s, d)
    y, s_last = rwkv6_scan(*map(_t, (r, k, v, w, u, s0)))
    st = s0.astype(np.float64)
    ys = np.empty((b, h, s, d))
    for t in range(s):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        ys[:, :, t] = np.einsum("bhk,bhkv->bhv", r[:, :, t],
                                st + u[None, :, :, None] * kv)
        st = w[:, :, t, :, None] * st + kv
    np.testing.assert_allclose(y.numpy(), ys, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(s_last.numpy(), st, rtol=2e-5, atol=2e-5)


def test_scan_writes_out_and_keeps_dtype():
    x = list(map(_t, _scan_inputs(np.random.default_rng(3), 2, 2, 5, 16)))
    out = torch.empty(2, 5, 2, 16).transpose(1, 2)       # (B,S,H,D) buffer
    y, _ = rwkv6_scan(*x, out=out)
    assert y is out
    torch.testing.assert_close(out, rwkv6_scan(*x)[0])
    yb, sb = rwkv6_scan(*(t.bfloat16() for t in x[:4]), x[4], x[5])
    assert yb.dtype == torch.bfloat16 and sb.dtype == torch.float32


@pytest.mark.parametrize("bad", ["u_shape", "s0_shape", "dtype", "empty"])
def test_scan_rejects_bad_inputs(bad):
    r, k, v, w, u, s0 = map(_t, _scan_inputs(np.random.default_rng(4),
                                             1, 2, 4, 16))
    if bad == "u_shape":
        u = u[:1]
    elif bad == "s0_shape":
        s0 = s0[..., :8]
    elif bad == "dtype":
        k = k.double()
    else:
        r, k, v, w = (t[:, :, :0] for t in (r, k, v, w))
    with pytest.raises((ValueError, TypeError)):
        rwkv6_scan(r, k, v, w, u, s0)


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


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 7, 64)) * 3 + 1).astype(np.float32)
    scale, bias = (rng.normal(size=(64,)).astype(np.float32)
                   for _ in range(2))
    np.testing.assert_allclose(
        TA.layer_norm(_t(x), _t(scale), _t(bias)).numpy(),
        np.asarray(JA.layer_norm(*map(jnp.asarray, (x, scale, bias)))),
        rtol=1e-6, atol=1e-6)


def test_converted_tree_is_one_dict_per_layer(weights):
    jcfg, tcfg, jparams, tparams = weights
    assert len(tparams["blocks"]) == tcfg.n_layers
    np.testing.assert_array_equal(
        tparams["blocks"][2]["tm"]["u"].numpy(),
        np.asarray(jparams["blocks"]["tm"]["u"][2]))


@pytest.mark.parametrize("s", [1, 16])
def test_time_mix_and_channel_mix_match_reference(weights, monkeypatch, s):
    monkeypatch.setenv("REPRO_VARIANT", "rwkv_scan")
    jcfg, tcfg, jparams, tparams = weights
    rng = np.random.default_rng(s)
    d, hd = tcfg.d_model, tcfg.rwkv_head_dim
    x = rng.normal(size=(2, s, d)).astype(np.float32)
    prev = rng.normal(size=(2, d)).astype(np.float32)
    st = (rng.normal(size=(2, d // hd, hd, hd)) * 0.1).astype(np.float32)
    jtm = jax.tree.map(lambda a: a[1], jparams["blocks"]["tm"])
    jcm = jax.tree.map(lambda a: a[1], jparams["blocks"]["cm"])
    tb = tparams["blocks"][1]
    jout = jrwkv6.time_mix(jcfg, jtm, *map(jnp.asarray, (x, prev, st)))
    tout = trwkv6.time_mix(tcfg, tb["tm"], *map(_t, (x, prev, st)))
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    jout = jrwkv6.channel_mix(jcm, jnp.asarray(x), jnp.asarray(prev))
    tout = trwkv6.channel_mix(tb["cm"], _t(x), _t(prev))
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("variant,seq,tol", [
    ("", 64, 2e-3), ("", 128, 2e-3),
    ("rwkv_scan", 32, 1e-4), ("rwkv_scan", 128, 1e-4),
])
def test_forward_matches_reference(weights, monkeypatch, variant, seq, tol):
    monkeypatch.setenv("REPRO_VARIANT", variant)
    jcfg, tcfg, jparams, tparams = weights
    tokens = _tokens(tcfg, 2, seq, seq)
    expect = japi.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    got = tapi.forward(tcfg, tparams, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, seq, tcfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=tol,
                               atol=tol)


def test_hidden_and_unembed_compose_to_forward(weights):
    _, tcfg, _, tparams = weights
    batch = {"tokens": torch.from_numpy(_tokens(tcfg, 2, 9, 1))}
    hidden = tapi.forward_hidden(tcfg, tparams, batch)
    assert hidden.shape == (2, 9, tcfg.d_model)
    torch.testing.assert_close(tapi.unembed(tcfg, tparams, hidden),
                               tapi.forward(tcfg, tparams, batch))
    last = tapi.forward(tcfg, tparams, batch, last_token_only=True)
    torch.testing.assert_close(last, tapi.forward(tcfg, tparams,
                                                  batch)[:, -1:])


def test_decode_loop_matches_reference(weights, monkeypatch):
    """A 16-token prompt prefilled into the state in one call, then 8
    greedy steps, through both packages' ``api.decode``."""
    monkeypatch.setenv("REPRO_VARIANT", "rwkv_scan")
    jcfg, tcfg, jparams, tparams = weights
    prompt = _tokens(tcfg, 2, 16, 5)
    jcache = japi.init_cache(jcfg, 2, 32)
    tcache = tapi.init_cache(tcfg, 2, 32, CPU)
    jtok, ttok = prompt, torch.from_numpy(prompt)
    jtoks, ttoks = [], []
    for _ in range(9):
        jl, jcache = japi.decode(jcfg, jparams, jnp.asarray(jtok), jcache)
        tl, tcache = tapi.decode(tcfg, tparams, ttok, tcache)
        np.testing.assert_allclose(tl[:, -1].numpy(),
                                   np.asarray(jl[:, -1]), rtol=1e-4,
                                   atol=1e-4)
        jtok = np.asarray(jl[:, -1].argmax(-1))[:, None]
        ttok = tl[:, -1].argmax(-1, keepdim=True)
        jtoks.append(jtok)
        ttoks.append(ttok.numpy())
    np.testing.assert_array_equal(np.concatenate(ttoks, 1),
                                  np.concatenate(jtoks, 1))
    assert tcache["len"] == int(jcache["len"]) == 24


def test_decode_continues_the_forward(weights):
    """A prompt's last logits are the same whether the prompt runs as a
    forward or goes into the state token by token."""
    _, tcfg, _, tparams = weights
    tokens = torch.from_numpy(_tokens(tcfg, 2, 6, 2))
    cache = tapi.init_cache(tcfg, 2, 6, CPU)
    for i in range(6):
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
    assert tapi.param_count(cfg) == 1_599_868_928
    assert japi.param_count(jconfigs.get(ARCH).config()) == 1_599_868_928
    params = tapi.init(cfg, "meta")
    assert params["embed"].is_meta and len(params["blocks"]) == 24


@pytest.mark.parametrize("spec", [
    dict(stages=4, strategy="balanced"),
    dict(stages=2, strategy="decode_placement", workload="decode",
         max_context=128, decode_concurrency=4),
], ids=["balanced", "decode_placement"])
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
    assert "plan: rwkv6-1.6b-smoke" in out and "report:" in out
    assert "note: family 'ssm' (rwkv6-1.6b)" in out
    assert res["plan"].stage_layers


def test_api_raises_for_unported_families():
    # every reference family is ported; one the reference lacks is not
    cfg = dataclasses.replace(tconfigs.get(ARCH).smoke_config(),
                              family="diffusion")
    with pytest.raises(NotImplementedError, match="not ported"):
        tapi.init(cfg, "cpu")
