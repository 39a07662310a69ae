"""The port's remaining LM families against the JAX reference: qkv bias,
relu^2 MLPs, head dim 96, the mixture of experts and the M-RoPE VLM.

For the smoke configs of the six archs the LM-families slice adds, the same
numpy inputs and the reference's init (converted with
``params_from_numpy``) go through both packages.  Tolerances: 1e-6 for
``apply_mrope`` (fp32 arithmetic), 1e-4 for fp32 blocks and models
(summation order, elementwise as ``assert_allclose``); greedy tokens of
the decode engine are equal (fp32).

bf16: the largest deviation within 2e-2 of the logits' scale, max(1,
max |reference|) (the bound ``launch/serve.py`` checks the pipeline
against), on the last position of the forward (as ``test_torch_lm.py``)
and at every decode step.  The two packages round bf16 at different points
(XLA on the CPU evaluates fused bf16 elementwise chains in fp32), so an
untied head's logits of 3 to 4, whose bf16 ulp is 0.0156, differ by a few
ulps.  The moe family's bf16 decode loop is not compared logit by logit:
a top-k choice between two experts within rounding of each other may go
either way, and the flipped expert's output then lives on in the K/V cache
(the fp32 loops of both moe archs are the firm check).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import attention as JA
from repro.models import lm as jlm
from repro.models import lm_graph as jlm_graph
from repro_torch import configs as tconfigs
from repro_torch.decode.engine import PipelineDecodeEngine
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import attention as TA
from repro_torch.models import lm as tlm
from repro_torch.models import lm_graph as tlm_graph
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy

ARCHS = ["qwen2.5-14b", "minitron-4b", "phi3-mini-3.8b",
         "granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b", "qwen2-vl-72b"]
DTYPES = ["float32", "bfloat16"]
CPU = torch.device("cpu")
SEQ = 12            # tokens of the forward (vlm: after 4 patches)
DECODE_STEPS = 6


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _t(a):
    return tensor_from_numpy(np.asarray(a), CPU)


def _assert_close(got, expect, dtype):
    """fp32: elementwise within 1e-4; bf16: the largest deviation within
    2e-2 of max(1, max |expect|) (module docstring)."""
    if dtype == "float32":
        np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)
    else:
        err = np.abs(got - expect).max()
        assert err <= 2e-2 * max(1.0, np.abs(expect).max()), err


def _grid_positions(b, n_patches, n_text):
    """qwen2-vl's M-RoPE streams: patches on a (1, h, w) grid, then text
    at its index on all three streams -> (3, b, n_patches + n_text)."""
    side = int(round(n_patches ** 0.5))
    t = np.zeros(n_patches, np.int64)
    h = np.repeat(np.arange(side), side)
    w = np.tile(np.arange(side), side)
    text = np.arange(n_patches, n_patches + n_text)
    pos = np.stack([np.concatenate([s, text]) for s in (t, h, w)])
    return np.broadcast_to(pos[:, None], (3, b, n_patches + n_text)).copy()


def _configs(arch, dtype="float32", **over):
    jcfg = dataclasses.replace(jconfigs.get(arch).smoke_config(), **over)
    tcfg = dataclasses.replace(tconfigs.get(arch).smoke_config(), **over)
    return (dataclasses.replace(jcfg, dtype=getattr(jnp, dtype)),
            dataclasses.replace(tcfg, dtype=getattr(torch, dtype)))


@functools.lru_cache(maxsize=None)
def _weights(arch, dtype="float32", **over):
    """Both packages' configs and the reference's init as numpy, seed 0."""
    jcfg, tcfg = _configs(arch, dtype, **over)
    tree = jax.tree.map(np.asarray, japi.init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, tree


def _batch(cfg, seed, b=2):
    """numpy batch: tokens, and for vlm embeds and grid positions."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, SEQ)).astype(np.int32)}
    if cfg.family == "vlm":
        p = cfg.n_patches
        out["embeds"] = rng.standard_normal((b, p, cfg.d_model),
                                            dtype=np.float32)
        out["positions"] = _grid_positions(b, p, SEQ)
    return out


def _jbatch(jcfg, batch):
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    if "embeds" in out:
        out["embeds"] = out["embeds"].astype(jcfg.dtype)
    return out


def _tbatch(tcfg, batch):
    out = {k: torch.from_numpy(np.asarray(v, np.int64) if k != "embeds"
                               else v) for k, v in batch.items()}
    if "embeds" in out:
        out["embeds"] = out["embeds"].to(tcfg.dtype)
    return out


# ---------------------------------------------------------------- configs --

def _fields(cfg, dtype_names):
    d = dataclasses.asdict(cfg)
    d["dtype"] = dtype_names[d["dtype"]]
    return d


_JDT = {jnp.float32: "float32", jnp.bfloat16: "bfloat16"}
_TDT = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for which in ("config", "smoke_config"):
        j = getattr(jconfigs.get(arch), which)()
        t = getattr(tconfigs.get(arch), which)()
        assert _fields(t, _TDT) == _fields(j, _JDT), which


def test_every_lm_arch_but_whisper_is_registered():
    # every reference arch, whisper-tiny included, in the reference's
    # order
    assert tconfigs.arch_ids() == jconfigs.arch_ids()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_graph_match_reference(arch):
    jcfg = jconfigs.get(arch).config()
    tcfg = tconfigs.get(arch).config()
    assert tapi.param_count(tcfg) == japi.param_count(jcfg)
    assert tapi.active_param_count(tcfg) == japi.active_param_count(jcfg)
    jg = jlm_graph.lm_layer_graph(jcfg, seq_len=1024)
    tg = tlm_graph.lm_layer_graph(tcfg, seq_len=1024)

    def nodes(g):
        return [(n.name, n.params, n.macs, n.out_bytes, n.weight_bytes,
                 n.kind, tuple(g.predecessors(n.name)))
                for n in g.nodes.values()]
    assert nodes(tg) == nodes(jg)
    assert tg.depth == jg.depth


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tuple(tree.shape), str(tree.dtype).split(".")[-1]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference(arch):
    """The port's init (meta) has the reference's leaves, shapes and
    dtypes, with the stacked blocks split one dict a layer."""
    jcfg, tcfg = _configs(arch, "bfloat16")
    shapes = jax.eval_shape(lambda k: japi.init(jcfg, k),
                            jax.ShapeDtypeStruct((2,), "uint32"))
    want = []
    for path, shape, dtype in _leaves(shapes):
        if path[0] == "blocks":
            want += [(("blocks", i) + path[1:], shape[1:], dtype)
                     for i in range(shape[0])]
        else:
            want.append((path, shape, dtype))
    got = list(_leaves(tapi.init(tcfg, torch.device("meta"))))
    assert sorted(got) == sorted(want)


def test_vlm_concrete_batch_shapes():
    cfg = tconfigs.get("qwen2-vl-72b").smoke_config()
    batch = tconfigs.concrete_batch(cfg, 10, 2, kind="prefill")
    assert batch["tokens"].shape == (2, 10 - cfg.n_patches)
    assert batch["embeds"].shape == (2, cfg.n_patches, cfg.d_model)
    assert batch["embeds"].dtype == cfg.dtype
    assert batch["positions"].shape == (3, 2, 10)
    assert torch.equal(batch["positions"][2, 1], torch.arange(10))


# ------------------------------------------------------------- primitives --

def test_apply_mrope_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 20, 4, 16)).astype(np.float32)
    pos = _grid_positions(2, 16, 4)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    np.testing.assert_allclose(
        _np32(TA.apply_mrope(_t(x), torch.from_numpy(pos), (4, 2, 2),
                             1e6)),
        _np32(JA.apply_mrope(jnp.asarray(x), jnp.asarray(pos), (4, 2, 2),
                             1e6)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("capacity_factor", [8.0, 1.0])
def test_moe_block_matches_reference(capacity_factor):
    jcfg, tcfg, tree = _weights("granite-moe-1b-a400m")
    jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor,
                               moe_group=16)
    tcfg = dataclasses.replace(tcfg, capacity_factor=capacity_factor,
                               moe_group=16)
    p = jax.tree.map(lambda a: a[1], tree["blocks"]["mlp"])
    x = np.random.default_rng(1).normal(size=(2, 32, tcfg.d_model)) \
        .astype(np.float32)
    # does this capacity drop tokens? an expert chosen by more tokens of a
    # 16-token group than its capacity
    probs = jax.nn.softmax(jnp.asarray(x).reshape(4, 16, -1) @ p["router"])
    idx = np.asarray(jax.lax.top_k(probs, tcfg.top_k)[1])
    load = max(np.bincount(g.ravel(), minlength=tcfg.n_experts).max()
               for g in idx)
    cap = min(int(capacity_factor * 16 * tcfg.top_k / tcfg.n_experts) + 1,
              16)
    assert (load > cap) == (capacity_factor == 1.0), (load, cap)
    got = tlm.moe_block(tcfg, {k: _t(v) for k, v in p.items()}, _t(x))
    expect = jlm.moe_block(jcfg, jax.tree.map(jnp.asarray, p),
                           jnp.asarray(x))
    np.testing.assert_allclose(_np32(got), np.asarray(expect),
                               rtol=1e-4, atol=1e-4)


def test_params_from_numpy_splits_the_moe_tree_exactly():
    jcfg, tcfg, tree = _weights("phi3.5-moe-42b-a6.6b", "bfloat16")
    params = params_from_numpy(tcfg, tree, device="cpu")
    assert len(params["blocks"]) == tcfg.n_layers
    mlp = params["blocks"][2]["mlp"]
    assert mlp["router"].dtype == torch.float32
    assert mlp["router"].shape == (tcfg.d_model, tcfg.n_experts)
    assert mlp["wd"].shape == (tcfg.n_experts, tcfg.d_ff, tcfg.d_model)
    np.testing.assert_array_equal(mlp["router"].numpy(),
                                  tree["blocks"]["mlp"]["router"][2])
    assert mlp["wg"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        mlp["wg"].view(torch.int16).numpy(),
        tree["blocks"]["mlp"]["wg"][2].view(np.int16))


# ------------------------------------------------------------------ models --

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype):
    """fp32: the logits of every position; bf16: of the last."""
    jcfg, tcfg, tree = _weights(arch, dtype)
    batch = _batch(tcfg, seed=3)
    expect = japi.forward(jcfg, jax.tree.map(jnp.asarray, tree),
                          _jbatch(jcfg, batch))
    params = params_from_numpy(tcfg, tree, device="cpu")
    got = tapi.forward(tcfg, params, _tbatch(tcfg, batch))
    n = SEQ + (tcfg.n_patches if tcfg.family == "vlm" else 0)
    assert got.shape == expect.shape == (2, n, tcfg.vocab)
    assert got.dtype == torch.float32
    got, expect = _np32(got), np.asarray(expect)
    if dtype == "bfloat16":
        got, expect = got[:, -1], expect[:, -1]
    _assert_close(got, expect, dtype)


@functools.lru_cache(maxsize=None)
def _jit_decode(jcfg):
    return jax.jit(lambda p, t, c: jlm.forward_decode(jcfg, p, t, c))


def _decode_loop(arch, dtype, **over):
    """The same tokens fed one a step through both packages' decode from
    an empty cache: (port logits, reference logits), (B, steps, V)."""
    jcfg, tcfg, tree = _weights(arch, dtype, **over)
    toks = np.random.default_rng(4).integers(
        0, tcfg.vocab, (2, DECODE_STEPS)).astype(np.int32)
    step = _jit_decode(jcfg)
    jp = jax.tree.map(jnp.asarray, tree)
    jc = japi.init_cache(jcfg, 2, DECODE_STEPS + 2)
    params = params_from_numpy(tcfg, tree, device="cpu")
    tc = tapi.init_cache(tcfg, 2, DECODE_STEPS + 2, CPU)
    got, expect = [], []
    for i in range(DECODE_STEPS):
        lj, jc = step(jp, jnp.asarray(toks[:, i:i + 1]), jc)
        lt, tc = tapi.decode(tcfg, params,
                             torch.from_numpy(toks[:, i:i + 1]).long(), tc)
        expect.append(np.asarray(lj))
        got.append(_np32(lt))
    return np.concatenate(got, 1), np.concatenate(expect, 1)


@pytest.mark.parametrize("arch,dtype", [
    (a, d) for a in ARCHS for d in DTYPES
    if d == "float32" or tconfigs.get(a).config().family != "moe"])
def test_decode_loop_matches_reference(arch, dtype):
    got, expect = _decode_loop(arch, dtype)
    _assert_close(got, expect, dtype)


def test_head_dim_96_matches_reference():
    # phi3-mini's head dim at smoke width: the kernels' D 96 on the CPU
    got, expect = _decode_loop("phi3-mini-3.8b", "float32", head_dim=96)
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)
    jcfg, tcfg, tree = _weights("phi3-mini-3.8b", "float32", head_dim=96)
    batch = _batch(tcfg, seed=5)
    expect = japi.forward(jcfg, jax.tree.map(jnp.asarray, tree),
                          _jbatch(jcfg, batch))
    got = tapi.forward(tcfg, params_from_numpy(tcfg, tree, device="cpu"),
                       _tbatch(tcfg, batch))
    np.testing.assert_allclose(_np32(got), np.asarray(expect), rtol=1e-4,
                               atol=1e-4)


def test_layer_norm_and_gelu_blocks_match_reference():
    # no LM arch of the port uses them (whisper does): qwen2.5's smoke
    # config with layer-normed blocks and an ungated tanh-GELU MLP
    over = {"norm": "layer", "mlp_kind": "gelu"}
    got, expect = _decode_loop("qwen2.5-14b", "float32", **over)
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)
    jcfg, tcfg, tree = _weights("qwen2.5-14b", "float32", **over)
    assert set(tree["final_norm"]) == {"scale", "bias"}
    assert set(tree["blocks"]["mlp"]) == {"wu", "wd"}
    batch = _batch(tcfg, seed=8)
    expect = japi.forward(jcfg, jax.tree.map(jnp.asarray, tree),
                          _jbatch(jcfg, batch))
    got = tapi.forward(tcfg, params_from_numpy(tcfg, tree, device="cpu"),
                       _tbatch(tcfg, batch))
    np.testing.assert_allclose(_np32(got), np.asarray(expect), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_forward(arch):
    """api.prefill of a prompt (vlm: embeds and grid positions) and decode
    steps after it give the forward's logits of the whole sequence."""
    _, tcfg, tree = _weights(arch)
    params = params_from_numpy(tcfg, tree, device="cpu")
    batch = _tbatch(tcfg, _batch(tcfg, seed=6, b=1))
    n_prompt = 8
    prompt = {**batch, "tokens": batch["tokens"][:, :n_prompt]}
    p0 = tcfg.n_patches if tcfg.family == "vlm" else 0
    if "positions" in batch:
        prompt["positions"] = batch["positions"][:, :, :p0 + n_prompt]
    full = tapi.forward(tcfg, params, batch)
    cache = tapi.init_cache(tcfg, 1, p0 + SEQ, CPU)
    logits, cache = tapi.prefill(tcfg, params, prompt, cache)
    assert cache["len"] == p0 + n_prompt
    rows = [logits]
    for i in range(n_prompt, SEQ):
        out, cache = tapi.decode(tcfg, params, batch["tokens"][:, i:i + 1],
                                 cache)
        rows.append(out)
    torch.testing.assert_close(torch.cat(rows, 1), full, rtol=1e-4,
                               atol=1e-4)


def test_prefill_refuses_the_recurrent_families():
    cfg = tconfigs.get("rwkv6-1.6b").smoke_config()
    with pytest.raises(ValueError, match="attention families"):
        tapi.prefill(cfg, {}, {}, {})


def _reference_greedy(jcfg, jp, prompt, n_new, max_context):
    step = _jit_decode(jcfg)
    cache = jlm.init_cache(jcfg, 1, max_context)
    for tok in prompt:
        logits, cache = step(jp, jnp.asarray([[tok]], jnp.int32), cache)
    out = []
    for _ in range(n_new):
        out.append(int(jnp.argmax(logits[0, -1])))
        logits, cache = step(jp, jnp.asarray([[out[-1]]], jnp.int32), cache)
    return out


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2-vl-72b"])
def test_engine_matches_reference_forward_decode_exactly(arch):
    jcfg, tcfg, tree = _weights(arch)
    prompt = np.asarray([3, 1, 4, 1, 5, 9], np.int32)
    expect = _reference_greedy(jcfg, jax.tree.map(jnp.asarray, tree),
                               prompt, 5, 32)
    engine = PipelineDecodeEngine(
        tcfg, params_from_numpy(tcfg, tree, device="cpu"), n_slots=2,
        max_context=32, stage_blocks=[1, 3])
    with engine:
        tok = engine.prefill(1, prompt)
        got, ctx = [tok], prompt.size + 1
        while len(got) < 5:
            tok = engine.step([1], [ctx], [tok])[0]
            ctx += 1
            got.append(tok)
    assert got == expect


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "granite-moe-1b-a400m"])
def test_serve_stage_fns_match_direct_forward(arch):
    """The prefill serving stages (embed + blocks 0..1 | blocks 2..3 +
    last-token unembedding) against the reference's direct forward of the
    request's tokens (vlm: the default positions)."""
    jcfg, tcfg, tree = _weights(arch)
    params = params_from_numpy(tcfg, tree, device="cpu")
    tokens = np.random.default_rng(7).integers(0, tcfg.vocab, (1, 16))
    x = torch.from_numpy(tokens)
    for fn in tserve.make_stage_fns(tcfg, params, [2, 2], CPU):
        x = fn(x)
    expect = japi.forward(jcfg, jax.tree.map(jnp.asarray, tree),
                          {"tokens": jnp.asarray(tokens, jnp.int32)},
                          last_token_only=True)
    np.testing.assert_allclose(_np32(x), np.asarray(expect), rtol=1e-4,
                               atol=1e-4)


def test_serve_entry_point_serves_moe_on_cpu():
    res = tserve.main(["--arch", "granite-moe-1b-a400m", "--smoke",
                       "--device", "cpu", "--stages", "2", "--requests", "2",
                       "--seq", "16"])
    assert len(res["outs"]) == 2
    assert res["max_err"] < 1e-5
