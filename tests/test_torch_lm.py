"""The port's LM primitives and dense forward against the JAX reference.

Same numpy inputs, same weights (the reference's init, converted with
``params_from_numpy``).  Tolerances: 1e-6 for the fp32 primitives (one or
two ulps of their fp32 arithmetic), 1e-4 for the fp32 forward (summation
order over a few layers), 2e-2 for the bf16 forward (the bound
``launch/serve.py`` checks the pipeline against).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import attention as JA
from repro_torch import configs as tconfigs
from repro_torch.models import attention as TA
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy

ARCH = "qwen3-1.7b"
CPU = torch.device("cpu")


def _t(a):
    return tensor_from_numpy(np.asarray(a), CPU)


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32) * 3
    scale = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        _np32(TA.rms_norm(_t(x), _t(scale))),
        _np32(JA.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_apply_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 48, 4, 16)).astype(np.float32)
    pos = np.arange(48)[None, :]
    np.testing.assert_allclose(
        _np32(TA.apply_rope(_t(x), torch.from_numpy(pos), theta)),
        _np32(JA.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s,t,hq,hkv,causal,q_offset", [
    (16, 16, 4, 2, True, 0),
    (16, 16, 4, 4, False, 0),
    (8, 24, 4, 1, True, 16),
])
def test_full_attention_matches_reference(s, t, hq, hkv, causal, q_offset):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, s, hq, 16)).astype(np.float32)
    k = rng.normal(size=(2, t, hkv, 16)).astype(np.float32)
    v = rng.normal(size=(2, t, hkv, 16)).astype(np.float32)
    np.testing.assert_allclose(
        _np32(TA.full_attention(_t(q), _t(k), _t(v), causal=causal,
                                q_offset=q_offset)),
        _np32(JA.full_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                q_offset=q_offset)),
        rtol=1e-6, atol=1e-6)


def test_flash_layout_matches_full_attention():
    # what attn_block computes: the kernel path in (B, H, S, D) views of
    # the model's (B, S, H, D) projections equals the plain attention
    from repro_torch.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(3)
    q, k, v = (_t(rng.normal(size=(1, 40, h, 16)).astype(np.float32))
               for h in (4, 2, 2))
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2)).transpose(1, 2)
    torch.testing.assert_close(out, TA.full_attention(q, k, v),
                               rtol=1e-6, atol=1e-6)


def _configs(dtype):
    jcfg = jconfigs.get(ARCH).smoke_config()
    tcfg = tconfigs.get(ARCH).smoke_config()
    if dtype == "bfloat16":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    return jcfg, tcfg


def _reference(jcfg, seq, seed):
    params = japi.init(jcfg, jax.random.PRNGKey(seed))
    tokens = np.random.default_rng(seed).integers(
        0, jcfg.vocab, (2, seq)).astype(np.int32)
    logits = japi.forward(jcfg, params, {"tokens": jnp.asarray(tokens)},
                          last_token_only=True)
    return jax.tree.map(np.asarray, params), tokens, np.asarray(logits)


def test_params_from_numpy_is_exact_in_bf16():
    jcfg, tcfg = _configs("bfloat16")
    tree, _, _ = _reference(jcfg, 8, 0)
    params = params_from_numpy(tcfg, tree, device="cpu")
    assert len(params["blocks"]) == tcfg.n_layers
    wq = params["blocks"][1]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.view(torch.int16).numpy(),
        tree["blocks"]["attn"]["wq"][1].view(np.int16))


# seq 16 <= q_chunk (32): the reference's full-attention branch; seq 64:
# its query-chunked branch.  The port runs one kernel call for both.
@pytest.mark.parametrize("seq", [16, 64])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_forward_matches_reference(seq, dtype, tol):
    jcfg, tcfg = _configs(dtype)
    tree, tokens, expect = _reference(jcfg, seq, seed=seq)
    params = params_from_numpy(tcfg, tree, device="cpu")
    got = tlm.forward(tcfg, params, {"tokens": torch.from_numpy(tokens)},
                      last_token_only=True)
    assert got.shape == expect.shape == (2, 1, tcfg.vocab)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np32(got), expect, rtol=tol, atol=tol)


def test_full_logits_match_reference():
    jcfg, tcfg = _configs("float32")
    tree, tokens, _ = _reference(jcfg, 8, 5)
    params = params_from_numpy(tcfg, tree, device="cpu")
    expect = japi.forward(jcfg, jax.tree.map(jnp.asarray, tree),
                          {"tokens": jnp.asarray(tokens)})
    got = tlm.forward(tcfg, params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(_np32(got), np.asarray(expect),
                               rtol=1e-4, atol=1e-4)


def test_unported_configs_raise():
    cfg = tconfigs.get(ARCH).smoke_config()
    for over in ({"family": "moe", "n_experts": 4, "top_k": 2},
                 {"qkv_bias": True}, {"mlp_kind": "gelu"}):
        with pytest.raises(NotImplementedError):
            tlm.init_params(dataclasses.replace(cfg, **over), CPU)


def test_meta_init_allocates_nothing():
    params = tlm.init_params(tconfigs.get(ARCH).config(),
                             torch.device("meta"))
    assert params["embed"].shape == (151936, 2048)
    assert params["embed"].is_meta
    assert "head" not in params                      # tied embeddings


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jcfg, tcfg = _configs("float32")
    tree, _, _ = _reference(jcfg, 8, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(tcfg, tree)
