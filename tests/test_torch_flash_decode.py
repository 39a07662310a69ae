"""The port's flash-decode plain version and wrapper against the JAX
package: the Pallas kernel in interpret mode and its jnp oracle
(``repro.kernels.ref.flash_decode_ref``), on the reference's own cases
(``tests/test_flash_decode.py``) plus per-slot lengths, and the model's
``decode_attention`` against the reference's.

Same numpy inputs from a seed through both packages.  Tolerances: 2e-6 in
fp32 (the reference's own kernel-vs-oracle bound; both sides are fp32
softmax over the same products), 2e-2 in bf16 (one bf16 rounding of
outputs of magnitude ~1).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref
from repro.kernels.flash_decode import flash_decode as pallas_flash_decode
from repro.models import attention as JA
from repro_torch.kernels import _build
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels.ref import flash_decode_ref
from repro_torch.models import attention as TA
from repro_torch.models.convert import tensor_from_numpy

CPU = torch.device("cpu")
TOL = {"float32": 2e-6, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(seed, b, hq, hkv, t, d, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=shape).astype(np.float32)
              for shape in ((b, hq, d), (b, hkv, t, d), (b, hkv, t, d))]
    jx = [jnp.asarray(a, JNP[dtype]) for a in arrays]
    tx = [tensor_from_numpy(np.asarray(a), CPU) for a in jx]
    return jx, tx


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


# the cases of tests/test_flash_decode.py:14-20
@pytest.mark.parametrize("b,hq,hkv,t,d,bk,cache_len", [
    (1, 2, 2, 256, 64, 128, 256),
    (2, 4, 2, 256, 64, 128, 200),
    (1, 8, 1, 512, 128, 128, 130),
    (2, 4, 4, 128, 64, 64, 1),
    (1, 2, 2, 256, 64, 256, 256),
])
def test_plain_matches_pallas_interpret_and_oracle(b, hq, hkv, t, d, bk,
                                                   cache_len):
    jx, tx = _inputs(7, b, hq, hkv, t, d)
    got = _np32(flash_decode_ref(*tx, cache_len))
    kernel = pallas_flash_decode(*jx, jnp.asarray(cache_len, jnp.int32),
                                 bk=bk, interpret=True)
    oracle = jref.flash_decode_ref(*jx, cache_len)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=2e-6,
                               atol=2e-6)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=2e-6,
                               atol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_slot_lengths_match_the_oracle_row_by_row(dtype):
    # each slot of the (B,) vector against the oracle at that slot's
    # scalar length, and against the oracle with a (B,1,1,1) length
    lens = np.asarray([1, 63, 64, 65, 200, 256], np.int32)
    b, hq, hkv, t, d = lens.size, 4, 2, 256, 32
    jx, tx = _inputs(1, b, hq, hkv, t, d, dtype)
    got = _np32(flash_decode_ref(*tx, torch.from_numpy(lens)))
    broadcast = jref.flash_decode_ref(*jx, jnp.asarray(lens)[:, None, None,
                                                              None])
    np.testing.assert_allclose(got, _np32(broadcast), rtol=TOL[dtype],
                               atol=TOL[dtype])
    for i, n in enumerate(lens):
        row = jref.flash_decode_ref(*(x[i:i + 1] for x in jx), int(n))
        np.testing.assert_allclose(got[i:i + 1], _np32(row),
                                   rtol=TOL[dtype], atol=TOL[dtype])


def test_bf16_matches_pallas_interpret():
    jx, tx = _inputs(2, 1, 4, 2, 256, 64, "bfloat16")
    got = flash_decode_ref(*tx, 180)
    assert got.dtype == torch.bfloat16
    kernel = pallas_flash_decode(*jx, jnp.asarray(180, jnp.int32),
                                 interpret=True)
    np.testing.assert_allclose(_np32(got), _np32(kernel), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_gqa_group_sizes_match_pallas_interpret(group):
    b, hq, t, d = 2, 8, 256, 32
    jx, tx = _inputs(3, b, hq, hq // group, t, d)
    got = _np32(flash_decode_ref(*tx, 193))
    kernel = pallas_flash_decode(*jx, jnp.asarray(193, jnp.int32), bk=64,
                                 interpret=True)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=2e-6,
                               atol=2e-6)


def test_length_zero_gives_zeros_as_the_pallas_kernel():
    # the TPU kernel skips every block, leaving its denominator at 0
    jx, tx = _inputs(4, 2, 4, 2, 128, 64)
    kernel = pallas_flash_decode(*jx, jnp.asarray(0, jnp.int32), bk=64,
                                 interpret=True)
    assert not np.asarray(kernel).any()
    assert not flash_decode_ref(*tx, 0).any()
    mixed = flash_decode_ref(*tx, torch.tensor([0, 70], dtype=torch.int32))
    assert not mixed[0].any()
    np.testing.assert_allclose(
        _np32(mixed[1:]), _np32(jref.flash_decode_ref(*(x[1:] for x in jx),
                                                      70)),
        rtol=2e-6, atol=2e-6)


def test_length_past_the_cache_means_all_positions():
    jx, tx = _inputs(5, 2, 4, 2, 128, 16)
    np.testing.assert_allclose(_np32(flash_decode_ref(*tx, 500)),
                               _np32(jref.flash_decode_ref(*jx, 128)),
                               rtol=2e-6, atol=2e-6)


def test_wrapper_takes_the_plain_version_on_cpu_without_counting():
    _, (q, k, v) = _inputs(6, 3, 4, 2, 64, 16)
    lens = torch.tensor([5, 0, 64], dtype=torch.int32)
    before = _build.launches("flash_decode")
    got = fd.flash_decode(q, k, v, lens)
    # only kernel launches count
    assert _build.launches("flash_decode") == before
    torch.testing.assert_close(got, flash_decode_ref(q, k, v, lens),
                               rtol=0, atol=0)
    # a (B, T, Hkv, D) cache passed as a strided (B, Hkv, T, D) view
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    torch.testing.assert_close(
        fd.flash_decode(q, kt.transpose(1, 2), vt.transpose(1, 2), lens),
        got, rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, (q, k, v) = _inputs(0, 2, 4, 2, 64, 16)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        fd.flash_decode(q[:, :3], k, v, 4)
    with pytest.raises(ValueError, match="one shape"):
        fd.flash_decode(q, k, v[:, :, :10], 4)
    with pytest.raises(TypeError, match="one dtype"):
        fd.flash_decode(q.double(), k.double(), v.double(), 4)
    with pytest.raises(ValueError, match=r"\(2,\) tensor"):
        fd.flash_decode(q, k, v, torch.tensor([1, 2, 3]))
    # meta tensors take the kernel's route up to the launch; any other
    # device raises
    out = fd.flash_decode(q.to("meta"), k.to("meta"), v.to("meta"), 4)
    assert (out.device.type, out.shape) == ("meta", q.shape)

    class OffDevice:
        def __init__(self, t):
            self.shape, self.dtype = t.shape, t.dtype
            self.device, self.dim = torch.device("xla"), t.dim

    with pytest.raises(ValueError, match="CUDA, CPU or meta"):
        fd.flash_decode(*map(OffDevice, (q, k, v)), 4)


def test_decode_attention_matches_reference_per_slot():
    # the engine's call: q (B,1,Hq,D) against (B,T,Hkv,D) caches with
    # per-slot lengths ctx[:, None]
    rng = np.random.default_rng(8)
    b, hq, hkv, t, d = 4, 4, 2, 48, 16
    q = rng.normal(size=(b, 1, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, t, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, t, hkv, d)).astype(np.float32)
    ctx = np.asarray([1, 17, 47, 48], np.int32)
    got = TA.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              torch.from_numpy(ctx)[:, None])
    expect = JA.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(ctx)[:, None])
    np.testing.assert_allclose(_np32(got), np.asarray(expect), rtol=2e-6,
                               atol=2e-6)
    # the kernel's plain version computes the same on the transposed view
    kern = flash_decode_ref(torch.from_numpy(q)[:, 0],
                            torch.from_numpy(k).transpose(1, 2),
                            torch.from_numpy(v).transpose(1, 2),
                            torch.from_numpy(ctx))
    np.testing.assert_allclose(_np32(kern), np.asarray(expect)[:, 0],
                               rtol=2e-6, atol=2e-6)


# ---------------------------------------------------------------------------
# the kernel's split plan and its split-then-merge, in plain arithmetic
# ---------------------------------------------------------------------------
N_SM = 132                    # an H100's SMs


@pytest.mark.parametrize("b,hkv,t,d", [
    (8, 8, 2048, 128),        # qwen3 decode
    (16, 1, 64, 256),         # recurrentgemma's decode loop
    (16, 1, 2048, 256),       # recurrentgemma's full window
    (1, 1, 5000, 64), (3, 2, 300, 128), (64, 8, 4096, 128), (2, 4, 17, 16),
    (1, 1, 1, 32),
])
def test_split_plan_covers_every_position_once(b, hkv, t, d):
    nsplit = fd.split_plan(b, hkv, t, d, N_SM)
    assert nsplit >= 1
    # the blocks fill the card's resident slots in one wave where T
    # allows, and never spill into a second one
    resident = N_SM * (1 if d >= 256 else 2)
    if nsplit > 1:
        assert b * hkv * nsplit <= resident
    if t >= fd.KEY_TILE * fd.WARPS * (resident // (b * hkv)):
        assert b * hkv * nsplit > resident - b * hkv
    lengths = range(t + 1) if t <= 2048 else range(0, t + 1, 7)
    for length in lengths:
        n = fd.split_length(length, nsplit)
        assert n % fd.KEY_TILE == 0
        covered = [p for i in range(nsplit)
                   for p in range(i * n, min((i + 1) * n, length))]
        assert covered == list(range(length))


def test_split_length_balances_a_row():
    # qwen3's timed point: 1056 valid positions of 2048 over 4 splits
    assert fd.split_plan(8, 8, 2048, 128, N_SM) == 4
    assert fd.split_length(1056, 4) == 272         # 3 x 272 + 240
    assert fd.split_length(0, 4) == 0
    assert fd.split_plan(16, 1, 2048, 256, N_SM) == 8
    assert fd.split_plan(16, 1, 64, 256, N_SM) == 1   # one block's tiles


def _split_merge(q, k, v, lens, nsplit):
    """The kernel's two passes in plain fp32: each split's (max,
    denominator, accumulator) over its positions, then the merge of the
    splits that saw a position; a row of length 0 is zeros."""
    b, hq, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    group = hq // hkv
    out = torch.zeros(b, hq, d)
    for row in range(b):
        length = min(max(int(lens[row]), 0), t)
        n = fd.split_length(length, nsplit)
        parts = []
        for i in range(nsplit):
            lo, hi = i * n, min((i + 1) * n, length)
            if lo >= hi:
                continue
            for h in range(hq):
                kh, vh = k[row, h // group, lo:hi], v[row, h // group, lo:hi]
                s = (kh.float() @ q[row, h].float()) * d ** -0.5
                m = s.max()
                p = torch.exp(s - m)
                parts.append((h, m, p.sum(), p @ vh.float()))
        for h in range(hq):
            mine = [(m, l, acc) for hh, m, l, acc in parts if hh == h]
            if not mine:
                continue
            mx = max(m for m, _, _ in mine)
            den = sum(l * torch.exp(m - mx) for m, l, _ in mine)
            num = sum(acc * torch.exp(m - mx) for m, _, acc in mine)
            out[row, h] = num / max(float(den), 1e-30)
    return out


@pytest.mark.parametrize("group", [1, 2, 8, 16])
def test_split_merge_matches_plain_and_pallas_interpret(group):
    """Lengths of 0, ending inside a split, on a split's edge and past T,
    through the split plan of a small batch (several splits a row)."""
    b, hkv, t, d = 6, 2, 256, 32
    lens = [0, 1, 63, 64, 150, 1000]
    jx, tx = _inputs(10 + group, b, group * hkv, hkv, t, d)
    nsplit = fd.split_plan(b, hkv, t, d, N_SM)
    assert nsplit == 4
    got = _split_merge(*tx, lens, nsplit)
    np.testing.assert_allclose(
        got.numpy(), _np32(flash_decode_ref(*tx, torch.tensor(lens))),
        rtol=2e-6, atol=2e-6)
    for row, n in enumerate(lens):
        kernel = pallas_flash_decode(*(x[row:row + 1] for x in jx),
                                     jnp.asarray(min(n, t), jnp.int32),
                                     bk=64, interpret=True)
        np.testing.assert_allclose(got[row:row + 1].numpy(),
                                   np.asarray(kernel), rtol=2e-6, atol=2e-6)
