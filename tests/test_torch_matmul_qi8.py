"""The port's int8 API (``kernels/matmul_qi8.py``, ``kernels/quant.py``)
against the JAX package's (``repro/kernels/matmul_qi8.py``, ``ops.py``).

On the CPU the wrapper runs its plain version (an int32 product).  Every
product here is exact: it must equal the reference's oracle, its Pallas
kernel in interpret mode on the five shapes of ``tests/test_kernels.py``
and numpy's int64 product on ragged shapes, bit for bit.  ``quantize_int8``
must give the reference's q and scale bit for bit; the dequantized
products (fp32, the same two multiplications in the same order) too.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.matmul_qi8 import matmul_qi8 as jmatmul_pallas
from repro_torch.kernels import _build, quant
from repro_torch.kernels import matmul_qi8 as mq
from repro_torch.kernels.matmul_qi8 import matmul_qi8
from repro_torch.kernels.ref import matmul_qi8_ref


def _int8(rng, shape):
    return rng.integers(-128, 128, shape, dtype=np.int8)


@pytest.mark.parametrize("m,k,n,block", [
    (128, 128, 128, (128, 128, 128)),
    (256, 384, 128, (128, 128, 128)),
    (384, 256, 512, (128, 128, 128)),
    (256, 256, 256, (128, 128, 64)),
    (512, 128, 256, (256, 128, 128)),
])
def test_matches_oracle_and_pallas_interpret(m, k, n, block):
    rng = np.random.default_rng(m + k + n)
    x, w = _int8(rng, (m, k)), _int8(rng, (k, n))
    before = _build.launches("matmul_qi8")
    got = matmul_qi8(torch.from_numpy(x), torch.from_numpy(w))
    assert _build.launches("matmul_qi8") == before       # CPU: no launch
    assert got.dtype == torch.int32 and got.shape == (m, n)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    for expect in (jref.matmul_qi8_ref(jx, jw),
                   jmatmul_pallas(jx, jw, block=block, interpret=True)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(expect))
    np.testing.assert_array_equal(
        got.numpy(), matmul_qi8_ref(torch.from_numpy(x),
                                    torch.from_numpy(w)).numpy())


@pytest.mark.parametrize("m,k,n", [
    (1, 1, 1), (8, 2048, 1000), (7, 30, 13), (100, 3, 129),
    (33, 4, 65), (3, 0, 5),
])
def test_ragged_shapes_are_exact(m, k, n):
    """Any (M, K, N), K not a multiple of 4 included (the ResNet head's
    N = 1000, a ragged K = 30), against numpy's int64 product; the
    extremes -128 x -128 summed K times must not wrap."""
    rng = np.random.default_rng(k)
    x, w = _int8(rng, (m, k)), _int8(rng, (k, n))
    x[:1], w[:, :1] = -128, -128
    got = matmul_qi8(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(
        got.numpy(), x.astype(np.int64) @ w.astype(np.int64))


def test_rejects_bad_inputs():
    x = torch.zeros(4, 8, dtype=torch.int8)
    for bad in ((x, torch.zeros(4, 8, dtype=torch.int8)),
                (x.float(), torch.zeros(8, 4)),
                (x, torch.zeros(8, 4, dtype=torch.int32)),
                (x[0], torch.zeros(8, 4, dtype=torch.int8))):
        with pytest.raises((ValueError, TypeError)):
            matmul_qi8(*bad)


@pytest.mark.parametrize("shape,scale", [((64, 64), 1.0), ((8, 2048), 3.0),
                                         ((5, 7), 1e-3), ((3, 4), 0.0)])
def test_quantize_int8_is_bit_equal(shape, scale):
    x = (np.random.default_rng(1).normal(size=shape) * scale).astype(
        np.float32)
    q, s = quant.quantize_int8(torch.from_numpy(x))
    jq, js = jops.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)


def test_quantize_roundtrip():
    """The reference's round-trip bound (``tests/test_kernels.py``): q s is
    within 0.51 s of x."""
    x = torch.from_numpy(np.random.default_rng(42).normal(
        size=(64, 64)).astype(np.float32))
    q, s = quant.quantize_int8(x)
    assert (q.float() * s - x).abs().max().item() <= s.item() * 0.51


@pytest.mark.parametrize("m,k,n", [(16, 64, 32), (8, 30, 1000)])
def test_scaled_matmul_and_quantized_dense_are_bit_equal(m, k, n):
    rng = np.random.default_rng(m * n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)
    xq, sx = quant.quantize_int8(torch.from_numpy(x))
    wq, sw = quant.quantize_int8(torch.from_numpy(w))
    got = quant.matmul_qi8(xq, wq, sx, sw)
    expect = jops.matmul_qi8(jnp.asarray(xq.numpy()), jnp.asarray(wq.numpy()),
                             jnp.asarray(sx.item(), jnp.float32),
                             jnp.asarray(sw.item(), jnp.float32),
                             use_pallas=False)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))
    np.testing.assert_array_equal(
        quant.quantized_dense(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jops.quantized_dense(jnp.asarray(x), jnp.asarray(w))))


SPLIT_SHAPES = [  # m, k, n: the head, the card tests' split shapes, others
    (8, 2048, 1000), (1, 2048, 1000), (16, 2048, 1000), (1, 4096, 1000),
    (8, 4096, 1000), (16, 4096, 1000), (512, 512, 512), (25088, 64, 256),
    (1000, 30, 300), (8, 30, 1000), (16, 129, 64), (300, 129, 1000),
    (65, 129, 63), (3, 0, 5), (1, 1, 1), (17, 100_000, 8), (0, 64, 5),
]


@pytest.mark.parametrize("m,k,n", SPLIT_SHAPES)
def test_split_k_slices_cover_k_exactly(m, k, n):
    """The wrapper's launch plan: at least one slice, each a multiple of
    32 long, together covering [0, K) with none empty; more slices only
    while the output tiles leave SMs idle."""
    splits, chunk = mq.split_k(m, k, n)
    assert splits >= 1 and chunk > 0 and chunk % mq.K_STEP == 0
    assert (splits - 1) * chunk < max(k, 1) <= splits * chunk
    tiles = -(-m // mq.block_rows(m)) * -(-n // 64)
    if tiles >= mq.SMS:
        assert splits == 1
    else:
        assert tiles * (splits - 1) < mq.SMS


def test_split_k_splits_the_head():
    """ResNet50's int8 head: 16 tiles of 16 x 64 on 132 SMs, K = 2048, so
    K is cut; the 16-row tile serves M <= 16."""
    assert mq.block_rows(8) == 16 and mq.block_rows(17) == 64
    splits, chunk = mq.split_k(8, 2048, 1000)
    assert splits > 1 and 16 * splits <= mq.SMS


@pytest.mark.parametrize("m,k,n", [(8, 2048, 1000), (65, 129, 63),
                                   (16, 129, 64)])
def test_split_k_slices_sum_to_the_product(m, k, n):
    """The slices' partial products, added in any order, are the product
    exactly (integer addition is associative): what the kernel's int32
    atomics rely on."""
    rng = np.random.default_rng(m + k)
    x, w = (torch.from_numpy(_int8(rng, s)) for s in ((m, k), (k, n)))
    splits, chunk = mq.split_k(m, k, n)
    parts = [matmul_qi8_ref(x[:, i * chunk:(i + 1) * chunk],
                            w[i * chunk:(i + 1) * chunk])
             for i in range(splits)]
    assert torch.equal(sum(reversed(parts)), matmul_qi8_ref(x, w))
