"""The flash-attention backward's plain version and the CPU route of the
differentiable wrapper, against autograd and the JAX reference.

``flash_attention_bwd_ref`` (the step-by-step FlashAttention-2 backward
the CUDA kernel is held against on the card, ``tests/test_torch_cuda.py``;
its row sum D over P * dP) must equal autograd through the plain forward,
and ``jax.vjp`` of the reference's oracle (``repro/kernels/ref.py``
``flash_attention_ref``: causal or not, S < T) and of its model attention
(``repro/models/attention.py`` ``full_attention``: the window, queries
right-aligned by ``q_offset = T - S``, layout (B, S, H, D)).  Inputs are
drawn with numpy and handed to both packages.  Tolerances: fp32 1e-5 of
the gradient's scale max(1, max |reference|) (sums in another order);
bf16 2e-2 of it (both packages compute in fp32 from the same bf16 inputs
and round the result once, and the reference's ``full_attention`` also
rounds P to bf16 before P V).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref
from repro.models import attention as JA
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import (NEG_INF, flash_attention_bwd_ref,
                                     flash_attention_ref)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CASES = [  # b, hq, hkv, s, t, d, causal: groups 1/2/4, D 16/64/96, S < T
    (1, 2, 2, 24, 24, 16, True),
    (2, 4, 2, 17, 17, 64, True),
    (1, 4, 1, 9, 30, 96, True),
    (1, 4, 2, 12, 20, 16, False),
    (2, 8, 2, 16, 16, 64, False),
    (1, 2, 1, 20, 7, 96, False),
]
WINDOWED = [  # b, hq, hkv, s, t, d, causal, window
    (1, 4, 2, 24, 24, 16, True, 5),
    (1, 4, 1, 10, 30, 64, True, 8),
    (2, 2, 2, 16, 16, 96, False, 4),
]


def _inputs(seed, b, hq, hkv, s, t, d, dtype):
    """q, k, v and the output's gradient dO as numpy arrays."""
    rng = np.random.default_rng(seed)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    return [rng.normal(size=shape).astype(np_dt)
            for shape in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d),
                          (b, hq, s, d))]


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tol(dtype):
    return 1e-5 if dtype == "float32" else 2e-2


def _assert_scaled(got, expect, tol):
    g, e = _np32(got), _np32(expect)
    scale = max(1.0, float(np.abs(e).max()))
    assert float(np.abs(g - e).max()) <= tol * scale


def _plain_bwd(q, k, v, do, causal, window=None):
    """``flash_attention_bwd_ref`` from the plain forward's lse."""
    _, lse = flash_attention_ref(q, k, v, causal, window, return_lse=True)
    return flash_attention_bwd_ref(q, k, v, lse, do, causal, window)


def _autograd(fn, q, k, v, do):
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fn(*leaves)
    return torch.autograd.grad(out, leaves, do)


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal", CASES)
def test_bwd_ref_equals_autograd_through_the_plain_forward(
        b, hq, hkv, s, t, d, causal, window):
    q, k, v, do = map(_torch, _inputs(0, b, hq, hkv, s, t, d, "float32"))
    got = _plain_bwd(q, k, v, do, causal, window)
    expect = _autograd(lambda *x: flash_attention_ref(*x, causal, window),
                       q, k, v, do)
    for g, e in zip(got, expect):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, e, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal", CASES)
def test_bwd_matches_vjp_of_the_jax_oracle(b, hq, hkv, s, t, d, causal,
                                           dtype):
    arrays = _inputs(1, b, hq, hkv, s, t, d, dtype)
    q, k, v, do = map(_torch, arrays)
    _, vjp = jax.vjp(lambda *x: jref.flash_attention_ref(*x, causal=causal),
                     *map(jnp.asarray, arrays[:3]))
    expect = vjp(jnp.asarray(arrays[3]))
    plain = _plain_bwd(q, k, v, do, causal)
    wrapped = _autograd(lambda *x: fa.flash_attention(*x, causal=causal),
                        q, k, v, do)
    for got in (plain, wrapped):
        for g, e in zip(got, expect):
            assert g.dtype == TORCH_DTYPES[dtype]
            _assert_scaled(g, e, _tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal,window", WINDOWED)
def test_bwd_matches_vjp_of_full_attention(b, hq, hkv, s, t, d, causal,
                                           window, dtype):
    """The reference's model attention, in its (B, S, H, D) layout, with
    the window and right-aligned queries."""
    arrays = _inputs(2, b, hq, hkv, s, t, d, dtype)
    q, k, v, do = map(_torch, arrays)
    bshd = [jnp.asarray(a).transpose(0, 2, 1, 3) for a in arrays]
    _, vjp = jax.vjp(lambda *x: JA.full_attention(
        *x, causal=causal, q_offset=t - s, window=window), *bshd[:3])
    expect = [e.transpose(0, 2, 1, 3) for e in vjp(bshd[3])]
    plain = _plain_bwd(q, k, v, do, causal, window)
    wrapped = _autograd(lambda *x: fa.flash_attention(
        *x, causal=causal, window=window), q, k, v, do)
    for got in (plain, wrapped):
        for g, e in zip(got, expect):
            _assert_scaled(g, e, _tol(dtype))


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal", CASES)
def test_return_lse_is_the_logsumexp_of_the_masked_scores(
        b, hq, hkv, s, t, d, causal, window):
    qn, kn, vn, _ = _inputs(3, b, hq, hkv, s, t, d, "float32")
    out, lse = flash_attention_ref(_torch(qn), _torch(kn), _torch(vn),
                                   causal, window, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, s)
    torch.testing.assert_close(out, flash_attention_ref(
        _torch(qn), _torch(kn), _torch(vn), causal, window), rtol=0, atol=0)
    # numpy, in float64: scores of q head h against kv head h // group
    g = hq // hkv
    scores = np.einsum("bhsd,bhtd->bhst", qn.astype(np.float64),
                       np.repeat(kn, g, axis=1).astype(np.float64)) / d ** 0.5
    qpos = np.arange(s)[:, None] + t - s
    kpos = np.arange(t)[None, :]
    mask = np.ones((s, t), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = np.where(mask, scores, NEG_INF)
    top = scores.max(-1, keepdims=True)
    expect = (top + np.log(np.exp(scores - top).sum(-1, keepdims=True))
              )[..., 0]
    np.testing.assert_allclose(lse.numpy(), expect, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 5])
def test_function_cpu_route_equals_autograd_through_the_plain_version(
        dtype, window):
    q, k, v, do = map(_torch, _inputs(4, 2, 4, 2, 19, 19, 32, dtype))
    before = (_build.launches("flash_attention"),
              _build.launches("flash_attention_bwd"))
    got = _autograd(lambda *x: fa.flash_attention(*x, window=window),
                    q, k, v, do)
    # the CPU route launches nothing
    assert before == (_build.launches("flash_attention"),
                      _build.launches("flash_attention_bwd"))
    expect = _autograd(lambda *x: flash_attention_ref(*x, window=window),
                       q, k, v, do)
    for g, e in zip(got, expect):
        assert g.dtype == TORCH_DTYPES[dtype]
        _assert_scaled(g, e, _tol(dtype))


def test_wrapper_saves_nothing_without_grad():
    q, k, v, _ = map(_torch, _inputs(5, 1, 2, 2, 8, 8, 16, "float32"))
    out = fa.flash_attention(q, k, v)
    assert out.grad_fn is None
    q.requires_grad_()
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).grad_fn is None
    assert fa.flash_attention(q, k, v).grad_fn is not None


@pytest.mark.parametrize("bad,match", [
    ({"do": (1, 2, 7, 16)}, "do of q's shape"),
    ({"lse": (1, 2, 7)}, "fp32 lse"),
    ({"lse_dtype": torch.float64}, "fp32 lse"),
])
def test_bwd_wrapper_rejects_bad_inputs(bad, match):
    q, k, v, do = map(_torch, _inputs(6, 1, 2, 2, 8, 8, 16, "float32"))
    _, lse = flash_attention_ref(q, k, v, return_lse=True)
    if "do" in bad:
        do = torch.zeros(bad["do"])
    if "lse" in bad:
        lse = torch.zeros(bad["lse"])
    if "lse_dtype" in bad:
        lse = lse.to(bad["lse_dtype"])
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_bwd(q, k, v, lse, do)


def test_bwd_ref_row_sum_is_that_of_the_output():
    """D = rowsum(P * dP) over the recomputed P equals FlashAttention-2's
    rowsum(dO * O) of the plain forward's output (fp32)."""
    q, k, v, do = map(_torch, _inputs(7, 1, 4, 2, 20, 20, 16, "float32"))
    o, lse = flash_attention_ref(q, k, v, return_lse=True)
    qg = q.reshape(1, 2, 2, 20, 16)
    p = torch.exp(torch.einsum("bkgsd,bktd->bkgst", qg, k) / 4.0
                  - lse.reshape(1, 2, 2, 20, 1)).tril()
    dp = torch.einsum("bkgsd,bktd->bkgst", do.reshape(1, 2, 2, 20, 16), v)
    torch.testing.assert_close((p * dp).sum(-1).reshape(1, 4, 20),
                               (do * o).sum(-1), rtol=1e-5, atol=1e-5)
