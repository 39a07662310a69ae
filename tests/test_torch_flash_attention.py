"""The port's flash attention against the JAX oracle and Pallas kernel.

Inputs are drawn with numpy and handed to both packages.  Tolerances are
the reference's own (tests/test_kernels.py): 2e-6 in fp32, 2e-2 in bf16
(one bf16 rounding of outputs of magnitude ~1).  The CUDA kernel itself is
held against its plain version in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import attention as JA
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import flash_attention_ref

CASES = [  # b, hq, hkv, s, t, d, causal, dtype -- tests/test_kernels.py's
    (1, 2, 2, 128, 128, 64, True, "float32"),
    (2, 4, 2, 256, 256, 64, True, "float32"),
    (1, 8, 1, 128, 256, 128, True, "float32"),     # MQA, s != t
    (2, 2, 2, 128, 128, 64, False, "float32"),
    (1, 4, 4, 256, 256, 64, True, "bfloat16"),
]
RAGGED = [  # not multiples of the Pallas block: against the JAX oracle only
    (1, 4, 2, 200, 200, 64, True, "float32"),
    (1, 4, 2, 200, 200, 64, True, "bfloat16"),
    (2, 4, 1, 72, 200, 16, True, "float32"),
    (1, 2, 2, 24, 16, 16, False, "float32"),     # non-causal, s > t
]
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, b, hq, hkv, s, t, d, dtype):
    rng = np.random.default_rng(seed)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    return [rng.normal(size=shape).astype(np_dt)
            for shape in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d))]


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _tol(dtype):
    return 2e-6 if dtype == "float32" else 2e-2


@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal,dtype", CASES + RAGGED)
def test_ref_matches_jax_oracle(b, hq, hkv, s, t, d, causal, dtype):
    q, k, v = _inputs(0, b, hq, hkv, s, t, d, dtype)
    expect = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal)
    got = flash_attention_ref(_torch(q), _torch(k), _torch(v), causal=causal)
    assert got.dtype == TORCH_DTYPES[dtype]
    np.testing.assert_allclose(_np32(got), _np32(expect),
                               rtol=_tol(dtype), atol=_tol(dtype))


@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal,dtype", CASES)
def test_cpu_wrapper_matches_pallas_interpret(b, hq, hkv, s, t, d, causal,
                                              dtype):
    q, k, v = _inputs(1, b, hq, hkv, s, t, d, dtype)
    expect = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, interpret=True)
    before = _build.launches("flash_attention")
    got = fa.flash_attention(_torch(q), _torch(k), _torch(v), causal=causal)
    # the CPU path launches nothing
    assert _build.launches("flash_attention") == before
    np.testing.assert_allclose(_np32(got), _np32(expect),
                               rtol=_tol(dtype), atol=_tol(dtype))


def test_strided_views_match_contiguous():
    # the model passes (B, S, H, D) projections as transposed views
    q, k, v = (_torch(a) for a in _inputs(2, 1, 4, 2, 40, 40, 16, "float32"))
    views = [x.transpose(1, 2).contiguous().transpose(1, 2)
             for x in (q, k, v)]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(fa.flash_attention(*views),
                               fa.flash_attention(q, k, v), rtol=0, atol=0)


@pytest.mark.parametrize("shapes,dtypes,causal,exc", [
    (((1, 4, 8, 16), (1, 3, 8, 16), (1, 3, 8, 16)), None, True, ValueError),
    (((1, 4, 8, 16), (1, 2, 8, 32), (1, 2, 8, 32)), None, True, ValueError),
    (((1, 4, 8, 16), (1, 2, 8, 16), (1, 2, 9, 16)), None, True, ValueError),
    (((1, 4, 9, 16), (1, 2, 8, 16), (1, 2, 8, 16)), None, True, ValueError),
    (((1, 4, 8, 16),) * 3, (torch.float32, torch.bfloat16, torch.float32),
     True, TypeError),
    (((1, 4, 8, 16),) * 3, (torch.float16,) * 3, True, TypeError),
])
def test_wrapper_rejects_bad_inputs(shapes, dtypes, causal, exc):
    dtypes = dtypes or (torch.float32,) * 3
    q, k, v = (torch.zeros(s, dtype=dt) for s, dt in zip(shapes, dtypes))
    with pytest.raises(exc):
        fa.flash_attention(q, k, v, causal=causal)


@pytest.mark.parametrize("b,hq,hkv,s,t,d,window,dtype", [
    (1, 4, 2, 24, 24, 16, 8, "float32"),
    (2, 4, 1, 8, 24, 16, 5, "float32"),          # right-aligned queries
    (1, 16, 1, 40, 40, 32, 16, "float32"),       # recurrentgemma's 16:1
    (1, 2, 2, 40, 40, 16, 64, "float32"),        # wider than S: no mask
    (1, 4, 2, 64, 64, 16, 1, "float32"),         # each query sees itself
    (1, 4, 4, 96, 96, 64, 32, "bfloat16"),
])
def test_window_matches_reference(b, hq, hkv, s, t, d, window, dtype):
    """``window=`` against the reference's mask (``full_attention``: key
    kpos visible when qpos - window < kpos <= qpos), through the CPU
    wrapper; the reference takes (B, S, H, D) and an explicit q_offset."""
    q, k, v = _inputs(s + window, b, hq, hkv, s, t, d, dtype)
    got = fa.flash_attention(*map(_torch, (q, k, v)), causal=True,
                             window=window)
    expect = JA.full_attention(*(jnp.asarray(a).transpose(0, 2, 1, 3)
                                 for a in (q, k, v)),
                               causal=True, q_offset=t - s, window=window)
    np.testing.assert_allclose(_np32(got),
                               _np32(expect).transpose(0, 2, 1, 3),
                               rtol=_tol(dtype), atol=_tol(dtype))
    if window >= t:
        np.testing.assert_array_equal(
            _np32(got), _np32(fa.flash_attention(*map(_torch, (q, k, v)))))


def test_window_must_be_positive():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, q, q, window=0)
