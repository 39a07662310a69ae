"""The scans' backward plain versions and the CPU routes of the
differentiable wrappers, against ``jax.vjp`` of the JAX reference.

``rwkv6_scan_bwd_ref`` and ``rglru_scan_bwd_ref`` (the explicit reverse
recurrences the CUDA backward kernels are held against on the card,
``tests/test_torch_cuda.py``) must equal ``jax.vjp`` of the reference's
jnp oracles (``repro/kernels/ref.py`` ``rwkv6_scan_ref`` and
``rglru_scan_ref``) with cotangents on both outputs, and so must autograd
through the wrappers' CPU routes (their autograd Functions).  The piece
states that rwkv6's backward starts from (``rwkv6_scan_states_ref``, the
plain version of the forward kernel's checkpoint epilogue) must equal the
reference's final state over each prefix of 8p steps, and the Function
saves them only while autograd records; so must rglru's checkpoints
(``rglru_scan_checkpoints_ref``) the reference's h_last over each prefix of
64p steps, and its Function saves them in place of y.  Inputs are
drawn with numpy and handed to both packages; decays are drawn near 1 and
set to exactly 0 and 1 on some steps and channels (no route divides by a
decay).  Tolerances, the relative L2 error of each gradient: fp32 1e-5
(sums in another order); bf16 1e-2 (both packages compute in fp32 from the
same bf16 inputs and round each gradient once).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref
from repro_torch.kernels.ref import (RGLRU_PIECE, rglru_scan_bwd_ref,
                                     rglru_scan_checkpoints_ref,
                                     rglru_scan_ref, rwkv6_scan_bwd_ref,
                                     rwkv6_scan_ref, rwkv6_scan_states_ref)
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.rwkv6_scan import no_saved_states, rwkv6_scan

L2_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _np_dtype(dtype):
    return ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel_l2(got, expect):
    g, e = _np32(got), _np32(expect)
    norm = float(np.linalg.norm(e))
    return float(np.linalg.norm(g - e)) / (norm if norm > 0 else 1.0)


def _assert_grads(got, expect, dtype, names):
    assert len(got) == len(expect) == len(names)
    for name, g, e in zip(names, got, expect):
        assert tuple(g.shape) == tuple(e.shape), name
        assert np.isfinite(_np32(g)).all(), name
        err = _rel_l2(g, e)
        assert err <= L2_TOL[dtype], (name, err)


# ---------------------------------------------------------------------------
# rwkv6_scan
# ---------------------------------------------------------------------------
def _rwkv6_inputs(seed, b, h, s, d, dtype):
    """r, k, v, w (B, H, S, D) in ``dtype``, u (H, D), s0 (B, H, D, D) fp32,
    and the cotangents dy (``dtype``) and ds_last (fp32), as numpy.  w in
    (0.8, 1), then exactly 0 on every third step's even channels and
    exactly 1 on the steps after them."""
    rng = np.random.default_rng(seed)
    dt = _np_dtype(dtype)
    r, k, v = (rng.normal(size=(b, h, s, d)) * sc for sc in (1.0, 0.3, 1.0))
    w = 0.8 + 0.2 * rng.random((b, h, s, d))
    w[:, :, 0::3, 0::2] = 0.0
    w[:, :, 1::3, :] = 1.0
    u = (0.3 * rng.normal(size=(h, d))).astype(np.float32)
    s0 = (0.2 * rng.normal(size=(b, h, d, d))).astype(np.float32)
    dy = rng.normal(size=(b, h, s, d)).astype(dt)
    ds_last = rng.normal(size=(b, h, d, d)).astype(np.float32)
    return ([x.astype(dt) for x in (r, k, v, w)] + [u, s0]), dy, ds_last


def _rwkv6_vjp(xs, dy, ds_last):
    _, vjp = jax.vjp(jref.rwkv6_scan_ref, *map(jnp.asarray, xs))
    return vjp((jnp.asarray(dy), jnp.asarray(ds_last)))


RWKV6_NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("s", [1, 7, 64, 130])
def test_rwkv6_scan_bwd_ref_matches_jax_vjp(s, d, dtype):
    xs, dy, ds_last = _rwkv6_inputs(s * 10 + d, 2, 2, s, d, dtype)
    expect = _rwkv6_vjp(xs, dy, ds_last)
    got = rwkv6_scan_bwd_ref(*map(_torch, xs), _torch(dy), _torch(ds_last))
    for g, x in zip(got[:4], xs[:4]):
        assert g.dtype == _torch(x).dtype
    assert got[4].dtype == got[5].dtype == torch.float32
    _assert_grads(got, expect, dtype, RWKV6_NAMES)


def test_rwkv6_scan_bwd_ref_takes_absent_cotangents():
    """A cotangent that autograd does not pass (None) counts as zero."""
    xs, dy, ds_last = _rwkv6_inputs(0, 1, 2, 9, 16, "float32")
    expect = _rwkv6_vjp(xs, dy, np.zeros_like(ds_last))
    got = rwkv6_scan_bwd_ref(*map(_torch, xs), _torch(dy), None)
    _assert_grads(got, expect, "float32", RWKV6_NAMES)
    expect = _rwkv6_vjp(xs, np.zeros_like(dy), ds_last)
    got = rwkv6_scan_bwd_ref(*map(_torch, xs), None, _torch(ds_last))
    _assert_grads(got, expect, "float32", RWKV6_NAMES)


@pytest.mark.parametrize("dtype,s,d", [("float32", 7, 16),
                                       ("float32", 70, 64),
                                       ("bfloat16", 33, 32)])
def test_rwkv6_scan_cpu_route_gradients_match_jax_vjp(dtype, s, d):
    """Autograd through ``rwkv6_scan`` (its Function's CPU route: the plain
    forward, then ``rwkv6_scan_bwd_ref``), with r/k/v/w as (B, H, S, D)
    views of (B, S, H, D) tensors, as the model passes them."""
    xs, dy, ds_last = _rwkv6_inputs(5, 2, 3, s, d, dtype)
    expect = _rwkv6_vjp(xs, dy, ds_last)
    leaves = [_torch(np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                     ).requires_grad_() for x in xs[:4]]
    leaves += [_torch(x).requires_grad_() for x in xs[4:]]
    args = [x.transpose(1, 2) for x in leaves[:4]] + leaves[4:]
    y, s_last = rwkv6_scan(*args)
    torch.autograd.backward((y, s_last), (_torch(dy), _torch(ds_last)))
    got = [x.grad.transpose(1, 2) for x in leaves[:4]]
    got += [x.grad for x in leaves[4:]]
    _assert_grads(got, expect, dtype, RWKV6_NAMES)


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("s", [1, 7, 64, 130])
def test_rwkv6_scan_states_ref_matches_jax_prefix_s_last(s, d):
    """Piece p's state is the reference's s_last over the first 8p steps
    (fp32, 1e-5 relative L2), piece 0's exactly s0."""
    xs, _, _ = _rwkv6_inputs(s + d, 2, 2, s, d, "float32")
    r, k, v, w, u, s0 = xs
    states = rwkv6_scan_states_ref(*map(_torch, (k, v, w, s0)))
    assert states.shape == (2, 2, -(-s // 8), d, d)
    assert states.dtype == torch.float32
    torch.testing.assert_close(states[:, :, 0], _torch(s0), rtol=0, atol=0)
    for p in range(1, states.shape[2]):
        _, s_last = jref.rwkv6_scan_ref(
            *(jnp.asarray(x[:, :, :8 * p]) for x in (r, k, v, w)),
            jnp.asarray(u), jnp.asarray(s0))
        assert _rel_l2(states[:, :, p], s_last) <= L2_TOL["float32"], p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_scan_bwd_ref_from_states_equals_from_s0(dtype):
    """Starting each piece from its state gives the bits of walking from
    s0: both take the same steps."""
    xs, dy, ds_last = _rwkv6_inputs(2, 2, 3, 29, 16, dtype)
    args = [*map(_torch, xs), _torch(dy), _torch(ds_last)]
    states = rwkv6_scan_states_ref(*args[1:4], args[5])
    for a, c in zip(rwkv6_scan_bwd_ref(*args),
                    rwkv6_scan_bwd_ref(*args, states)):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_rwkv6_scan_saves_states_only_while_recording():
    """No Function (so nothing saved) under ``torch.no_grad`` or when no
    input requires grad; while recording, the piece states among the
    saved tensors; under ``no_saved_states`` a zero-stride stand-in of
    their shape, and the backward recomputes them (the same
    gradients)."""
    xs, dy, ds_last = _rwkv6_inputs(3, 2, 2, 20, 16, "float32")
    with torch.no_grad():
        y, s_last = rwkv6_scan(*(_torch(x).requires_grad_() for x in xs))
    assert y.grad_fn is None and s_last.grad_fn is None
    y, _ = rwkv6_scan(*map(_torch, xs))
    assert y.grad_fn is None
    grads = []
    for skip in (False, True):
        leaves = [_torch(x).requires_grad_() for x in xs]
        with no_saved_states() if skip else torch.enable_grad():
            y, s_last = rwkv6_scan(*leaves)
        saved = y.grad_fn.saved_tensors[-1]
        assert saved.shape == (2, 2, 3, 16, 16)
        if skip:
            assert set(saved.stride()) == {0}
        else:
            torch.testing.assert_close(
                saved, rwkv6_scan_states_ref(*leaves[1:4], leaves[5]),
                rtol=0, atol=0)
        torch.autograd.backward((y, s_last), (_torch(dy), _torch(ds_last)))
        grads.append([x.grad for x in leaves])
    for a, c in zip(*grads):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    _assert_grads(grads[0], _rwkv6_vjp(xs, dy, ds_last), "float32",
                  RWKV6_NAMES)


def test_rwkv6_scan_out_still_written_under_no_grad():
    xs, _, _ = _rwkv6_inputs(1, 2, 2, 12, 16, "float32")
    args = [_torch(x).requires_grad_() for x in xs]
    out = torch.empty(2, 12, 2, 16).transpose(1, 2)
    with torch.no_grad():
        y, s_last = rwkv6_scan(*args, out=out)
    assert y is out and not y.requires_grad
    y_ref, s_ref = rwkv6_scan_ref(*(x.detach() for x in args))
    torch.testing.assert_close(out, y_ref, rtol=0, atol=0)
    torch.testing.assert_close(s_last, s_ref, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# rglru_scan
# ---------------------------------------------------------------------------
def _rglru_inputs(seed, b, s, r, dtype):
    """a, g (B, S, R) in ``dtype``, h0 (B, R) fp32 and the cotangents dy
    (``dtype``) and dh_last (fp32), as numpy.  a in (0.3, 1), then
    exactly 0 on every third step's even channels and exactly 1 on the
    steps after them."""
    rng = np.random.default_rng(seed)
    dt = _np_dtype(dtype)
    a = 0.3 + 0.7 * rng.random((b, s, r))
    a[:, 0::3, 0::2] = 0.0
    a[:, 1::3, :] = 1.0
    g = 0.5 * rng.normal(size=(b, s, r))
    h0 = rng.normal(size=(b, r)).astype(np.float32)
    dy = rng.normal(size=(b, s, r)).astype(dt)
    dh_last = rng.normal(size=(b, r)).astype(np.float32)
    return [a.astype(dt), g.astype(dt), h0], dy, dh_last


def _rglru_vjp(xs, dy, dh_last):
    _, vjp = jax.vjp(jref.rglru_scan_ref, *map(jnp.asarray, xs))
    return vjp((jnp.asarray(dy), jnp.asarray(dh_last)))


RGLRU_NAMES = ("da", "dg", "dh0")


@pytest.mark.parametrize("checkpoints", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 7, 40, 64, 65, 130, 300])
def test_rglru_scan_bwd_ref_matches_jax_vjp(s, dtype, checkpoints):
    """From h0 and from the checkpoints, S across the 64-step pieces."""
    xs, dy, dh_last = _rglru_inputs(s, 2, s, 12, dtype)
    expect = _rglru_vjp(xs, dy, dh_last)
    a, g, h0 = map(_torch, xs)
    ckpt = rglru_scan_checkpoints_ref(a, g, h0) if checkpoints else None
    got = rglru_scan_bwd_ref(a, g, h0, _torch(dy), _torch(dh_last), ckpt)
    assert got[0].dtype == got[1].dtype == a.dtype
    assert got[2].dtype == torch.float32
    _assert_grads(got, expect, dtype, RGLRU_NAMES)


def test_rglru_scan_bwd_ref_recomputes_the_carry_of_bf16_inputs():
    """For bf16 inputs h_{t-1} is the fp32 carry recomputed from the
    widened inputs, not a rounded y: the bf16 gradients are the fp32
    plain version's on the widened inputs, rounded once."""
    xs, dy, dh_last = _rglru_inputs(3, 2, 140, 12, "bfloat16")
    a, g, h0 = map(_torch, xs)
    dy, dh_last = _torch(dy), _torch(dh_last)
    ckpt = rglru_scan_checkpoints_ref(a, g, h0)
    for got in (rglru_scan_bwd_ref(a, g, h0, dy, dh_last),
                rglru_scan_bwd_ref(a, g, h0, dy, dh_last, ckpt)):
        wide = rglru_scan_bwd_ref(a.float(), g.float(), h0, dy.float(),
                                  dh_last)
        for x, z in zip(got, wide):
            torch.testing.assert_close(x, z.to(x.dtype), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 40, 64, 65, 300])
def test_rglru_scan_checkpoints_ref_matches_jax_prefix_h_last(s, dtype):
    """Checkpoint p is the reference's h_last over the first 64p steps
    (fp32 whatever the inputs, 1e-5 relative L2), checkpoint 0 exactly
    h0."""
    xs, _, _ = _rglru_inputs(s + 5, 2, s, 12, dtype)
    a, g, h0 = xs
    ckpt = rglru_scan_checkpoints_ref(*map(_torch, xs))
    assert ckpt.shape == (2, -(-s // RGLRU_PIECE), 12)
    assert ckpt.dtype == torch.float32
    torch.testing.assert_close(ckpt[:, 0], _torch(h0), rtol=0, atol=0)
    for p in range(1, ckpt.shape[1]):
        n = RGLRU_PIECE * p
        _, h_last = jref.rglru_scan_ref(jnp.asarray(a[:, :n]),
                                        jnp.asarray(g[:, :n]),
                                        jnp.asarray(h0))
        assert _rel_l2(ckpt[:, p], h_last) <= L2_TOL["float32"], p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_scan_bwd_ref_from_checkpoints_equals_from_h0(dtype):
    """Starting each piece from its checkpoint gives the bits of walking
    from h0: both take the same steps."""
    xs, dy, dh_last = _rglru_inputs(4, 3, 200, 12, dtype)
    args = [*map(_torch, xs), _torch(dy), _torch(dh_last)]
    ckpt = rglru_scan_checkpoints_ref(*args[:3])
    for a, c in zip(rglru_scan_bwd_ref(*args),
                    rglru_scan_bwd_ref(*args, ckpt)):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_rglru_scan_saves_checkpoints_only_while_recording():
    """No Function (so nothing saved) under ``torch.no_grad`` or when no
    input requires grad; while recording, a, g, h0 and the checkpoints
    are saved and y is not."""
    xs, dy, dh_last = _rglru_inputs(5, 2, 130, 12, "float32")
    with torch.no_grad():
        y, h_last = rglru_scan(*(_torch(x).requires_grad_() for x in xs))
    assert y.grad_fn is None and h_last.grad_fn is None
    y, _ = rglru_scan(*map(_torch, xs))
    assert y.grad_fn is None
    leaves = [_torch(x).requires_grad_() for x in xs]
    y, h_last = rglru_scan(*leaves)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 4
    assert all(torch.equal(x, z) for x, z in zip(saved[:3], leaves))
    torch.testing.assert_close(saved[3],
                               rglru_scan_checkpoints_ref(*leaves),
                               rtol=0, atol=0)
    torch.autograd.backward((y, h_last), (_torch(dy), _torch(dh_last)))
    _assert_grads([x.grad for x in leaves], _rglru_vjp(xs, dy, dh_last),
                  "float32", RGLRU_NAMES)


@pytest.mark.parametrize("dtype,s", [("float32", 9), ("bfloat16", 70)])
def test_rglru_scan_cpu_route_gradients_match_jax_vjp(dtype, s):
    """Autograd through ``rglru_scan`` (its Function's CPU route), with a
    cotangent on h_last only for the fp32 case (dy then counts as zero in
    the backward) and on both for bf16."""
    xs, dy, dh_last = _rglru_inputs(7, 3, s, 20, dtype)
    if dtype == "float32":
        dy = np.zeros_like(dy)
    expect = _rglru_vjp(xs, dy, dh_last)
    leaves = [_torch(x).requires_grad_() for x in xs]
    y, h_last = rglru_scan(*leaves)
    if dtype == "float32":
        h_last.backward(_torch(dh_last))
    else:
        torch.autograd.backward((y, h_last), (_torch(dy), _torch(dh_last)))
    _assert_grads([x.grad for x in leaves], expect, dtype, RGLRU_NAMES)
