"""The port's recurrentgemma (hybrid family) and its RG-LRU scan against
the JAX package.

Same numpy inputs and the reference's weights (its init, converted with
``params_from_numpy``), fp32.  Tolerances:

* the plain ``rglru_scan`` (the CPU side of the kernel's wrapper) against
  the reference's oracle and its Pallas kernel in interpret mode: 1e-5, as
  ``tests/test_kernels.py`` holds the Pallas kernel to the oracle; against
  the recurrence written out in numpy: 2e-5;
* the kernel's staged route emulated in numpy on the plan's pieces and
  tiles against the oracle and the Pallas kernel in interpret mode: 1e-5
  (the same tolerance; the emulation runs the recurrence in its order);
  its checkpoint epilogue and the backward kernel's staged route, from
  those checkpoints, against ``jax.vjp`` of the oracle: 1e-5 relative L2
  (fp32 sums in another order, as ``tests/test_torch_scan_bwd.py``);
* model pieces and plain windowed attention: 1e-5 (fp32 arithmetic in
  another order);
* the smoke forward (S up to and above the smoke window of 16) and the
  decode loop (24 tokens, past the window, so the ring cache wraps):
  1e-4, greedy tokens equal.
"""
import dataclasses
import pathlib
import re

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
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels.ref import RGLRU_PIECE
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
# the kernel's launch plan and its staged route, emulated
# ---------------------------------------------------------------------------
_CSRC = pathlib.Path(rg.__file__).parent / "csrc"
_INSTANTIATED = {
    rg.ScanPlan("staged", *map(int, m)) for m in re.findall(
        r"RGLRU_PLAN\((\d+), (\d+), (\d+), (\d+)\)",
        (_CSRC / "rglru_scan.cu").read_text())}


@pytest.mark.parametrize("s,r,itemsize,want", [
    (1, 4096, 4, rg.STEP),                    # the decode step
    (rg.STAGED_MIN_S - 1, 4096, 4, rg.STEP),
    (rg.STAGED_MIN_S, 4096, 4, rg.STAGED),
    (1024, 4096, 4, rg.STAGED),               # recurrentgemma's forward
    (1024, 4096, 2, rg.STAGED),
    (4096, 4096, 4, rg.STAGED),               # above the 2048 window
    (1000, 1000, 4, rg.STAGED),               # a partial last tile
    (300, 1000, 2, rg.STAGED),
    (300, 1001, 4, rg.STEP),                  # rows off 16 bytes
    (300, 1004, 2, rg.STEP),
    (100, 7, 4, rg.STEP),
])
def test_scan_plan_routes_by_s_and_row_alignment(s, r, itemsize, want):
    """The staged route from STAGED_MIN_S steps on rows of whole 16-byte
    copies; the step route for short S (the S = 1 decode step), for other
    rows and for base pointers off 16 bytes."""
    assert rg.scan_plan(s, r, itemsize) == want
    assert rg.scan_plan(s, r, itemsize, aligned=False) == rg.STEP


def test_staged_plan_is_the_instantiated_one_and_fits_a_block():
    assert _INSTANTIATED == {rg.STAGED}
    plan = rg.STAGED
    assert plan.row_bytes // 2 <= plan.threads      # a thread a channel
    assert plan.stages >= 3
    assert 2 * plan.stages * plan.piece * plan.row_bytes <= 227 * 1024


@pytest.mark.parametrize("r,itemsize,want", [
    (4096, 4, rg.BWD_STAGED),                 # recurrentgemma's training
    (4096, 2, rg.BWD_STAGED),
    (1000, 4, rg.BWD_STAGED),                 # a partial last tile
    (1000, 2, rg.BWD_STAGED),
    (1001, 4, rg.STEP),                       # rows off 16 bytes
    (1004, 2, rg.STEP),
    (7, 4, rg.STEP),
])
def test_bwd_plan_routes_by_row_alignment(r, itemsize, want):
    """The backward takes its staged route on rows of whole 16-byte copies
    at any S, the step route on other rows and base pointers off 16
    bytes."""
    assert rg.bwd_plan(r, itemsize) == want
    assert rg.bwd_plan(r, itemsize, aligned=False) == rg.STEP


def test_bwd_plan_is_the_instantiated_one_and_its_pieces_are_the_checkpoints():
    """The backward's staged plan is the one instantiated in
    rglru_scan_bwd.cu, its pieces and the forward epilogue's checkpoint
    spacing are RGLRU_PIECE, a thread scans each channel of a tile, and
    two blocks' stages (a, g, dy and the checkpoint row) fit an SM."""
    src = (_CSRC / "rglru_scan_bwd.cu").read_text()
    piece = int(re.search(r"constexpr int kPiece = (\d+);", src).group(1))
    fwd = int(re.search(r"constexpr int kCkptPiece = (\d+);",
                        (_CSRC / "rglru_scan.cu").read_text()).group(1))
    assert piece == fwd == RGLRU_PIECE == rg.STAGED.piece
    plan = rg.BWD_STAGED
    assert {rg.ScanPlan("staged", int(rb), piece, int(st), int(th))
            for rb, st, th in re.findall(
                r"RGLRU_BWD_PLAN\((\d+), (\d+), (\d+)\)", src)} == {plan}
    assert plan.piece == RGLRU_PIECE
    assert plan.row_bytes // 2 <= plan.threads
    assert plan.stages >= 2           # a piece in flight while one scans
    smem = plan.stages * (3 * plan.piece * plan.row_bytes
                          + plan.row_bytes // 2 * 4)
    assert 2 * smem <= 227 * 1024


def _pieces(s, plan):
    """[start, stop) of every piece, as the kernel walks them."""
    return [(t0, min(t0 + plan.piece, s)) for t0 in range(0, s, plan.piece)]


def _copies(r, plan, itemsize):
    """(first channel, channels) of every 16-byte copy of a tile row the
    kernel issues for rows of ``r`` channels, over all tiles."""
    tile, per = plan.row_bytes // itemsize, 16 // itemsize
    return [(c0 + e, per) for c0 in range(0, r, tile)
            for e in range(0, tile, per) if c0 + e < r]


@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 257, 1000,
                               4096])
def test_pieces_cover_every_step_once(s):
    spans = _pieces(s, rg.STAGED)
    assert [t for lo, hi in spans for t in range(lo, hi)] == list(range(s))
    assert all(0 < hi - lo <= rg.STAGED.piece for lo, hi in spans)


@pytest.mark.parametrize("r,itemsize", [(4096, 4), (4096, 2), (1000, 4),
                                        (1000, 2), (12, 4), (8, 2)])
def test_tile_copies_cover_every_channel_once(r, itemsize):
    """On rows the staged route takes, the tiles' 16-byte copies (a copy
    wholly inside R or wholly past it, so past it is zero-filled) cover
    every channel once."""
    assert rg.staged_fits(r, itemsize)
    covered = [c for c0, n in _copies(r, rg.STAGED, itemsize)
               for c in range(c0, c0 + n)]
    assert covered == list(range(r))


def _staged_scan(a, g, h0, plan):
    """The staged route in numpy fp32, with the kernel's index math: for
    every (tile, batch row) block, each piece copied by whole 16-byte
    copies into a zero-filled stage, the carry written to its checkpoint,
    the tile's channels scanned in order over the piece's steps (y written
    over g's tile), then y's copies stored.  numpy multiplies and adds
    where the kernel fuses the two.  Returns (y, h_last, checkpoints)."""
    b, s, r = a.shape
    tile, per = plan.row_bytes // a.itemsize, 16 // a.itemsize
    y = np.full((b, s, r), np.nan, np.float32)
    h_last = np.full((b, r), np.nan, np.float32)
    ckpt = np.full((b, -(-s // plan.piece), r), np.nan, np.float32)
    for bi in range(b):
        for c0 in range(0, r, tile):
            cols = [e for e in range(0, tile, per) if c0 + e < r]
            scan = [c for c in range(tile) if c0 + c < r]
            h = h0[bi, [c0 + c for c in scan]].astype(np.float32)
            for t0, t1 in _pieces(s, plan):
                sa = np.zeros((plan.piece, tile), np.float32)
                sg = np.zeros((plan.piece, tile), np.float32)
                for e in cols:
                    sa[:t1 - t0, e:e + per] = a[bi, t0:t1, c0 + e:c0 + e + per]
                    sg[:t1 - t0, e:e + per] = g[bi, t0:t1, c0 + e:c0 + e + per]
                ckpt[bi, t0 // plan.piece, [c0 + c for c in scan]] = h
                for t in range(t1 - t0):
                    h = sa[t, scan] * h + sg[t, scan]
                    sg[t, scan] = h
                for e in cols:
                    y[bi, t0:t1, c0 + e:c0 + e + per] = sg[:t1 - t0, e:e + per]
            h_last[bi, [c0 + c for c in scan]] = h
    return y, h_last, ckpt


def _staged_bwd(a, g, ckpt, dy, dh_last, plan):
    """The backward kernel's staged route in numpy fp32, with its index
    math: for every (tile, batch row) block, the pieces from the last,
    each one's a, g and dy copied by whole 16-byte copies into zero-filled
    stages and its checkpoint row by 16-byte copies, the tile's channels'
    carries recomputed from the checkpoint in order, then walked backwards
    (da written over a's tile, dg over dy's), then da's and dg's copies
    stored.  Returns (da, dg, dh0)."""
    b, s, r = a.shape
    tile, per = plan.row_bytes // a.itemsize, 16 // a.itemsize
    da, dg = (np.full((b, s, r), np.nan, np.float32) for _ in range(2))
    dh0 = np.full((b, r), np.nan, np.float32)
    for bi in range(b):
        for c0 in range(0, r, tile):
            cols = [e for e in range(0, tile, per) if c0 + e < r]
            scan = [c for c in range(tile) if c0 + c < r]
            ch = [c0 + c for c in scan]
            grad = dh_last[bi, ch].astype(np.float32)
            for t0, t1 in reversed(_pieces(s, plan)):
                sa, sg, sd = (np.zeros((plan.piece, tile), np.float32)
                              for _ in range(3))
                sh = np.zeros(tile, np.float32)
                for e in cols:
                    for st, x in ((sa, a), (sg, g), (sd, dy)):
                        st[:t1 - t0, e:e + per] = x[bi, t0:t1,
                                                    c0 + e:c0 + e + per]
                for e in range(0, tile, 4):
                    if c0 + e < r:
                        sh[e:e + 4] = ckpt[bi, t0 // plan.piece,
                                           c0 + e:c0 + e + 4]
                h, prev = sh[scan], []
                for t in range(t1 - t0):
                    prev.append(h)
                    h = sa[t, scan] * h + sg[t, scan]
                for t in reversed(range(t1 - t0)):
                    at = sa[t, scan].copy()
                    grad = grad + sd[t, scan]
                    sd[t, scan] = grad
                    sa[t, scan] = grad * prev[t]
                    grad = at * grad
                for e in cols:
                    da[bi, t0:t1, c0 + e:c0 + e + per] = sa[:t1 - t0,
                                                            e:e + per]
                    dg[bi, t0:t1, c0 + e:c0 + e + per] = sd[:t1 - t0,
                                                            e:e + per]
            dh0[bi, ch] = grad
    return da, dg, dh0


def _decays(rng, b, s, r, kind):
    a = rng.uniform(0.3, 1.0, (b, s, r)).astype(np.float32)
    if kind == "one":
        a[:] = 1.0
    elif kind == "tiny":
        a[:] = 1e-30
    elif kind == "alternating":     # even channels 1; odd 1e-30 and 1
        a[..., 0::2] = 1.0
        a[:, 0::2, 1::2] = 1e-30
        a[:, 1::2, 1::2] = 1.0
    return a


@pytest.mark.parametrize("s,r", [(1, 40), (63, 40), (65, 36), (129, 12),
                                 (257, 44), (300, 8)])
@pytest.mark.parametrize("kind", ["mixed", "one", "tiny", "alternating"])
def test_staged_emulation_matches_oracle_and_pallas_interpret(s, r, kind):
    """The staged route's pieces and tiles, S across piece edges, R over a
    partial last tile, decays in (0.3, 1), exactly 1, 1e-30 and
    alternating, nonzero h0: every y and h_last written once, equal to the
    reference's oracle and its Pallas kernel in interpret mode within
    1e-5."""
    rng = np.random.default_rng(s + r)
    b = 2
    a = _decays(rng, b, s, r, kind)
    g = (rng.normal(size=(b, s, r)) * 0.2).astype(np.float32)
    h0 = rng.normal(size=(b, r)).astype(np.float32)
    y, h, _ = _staged_scan(a, g, h0, rg.STAGED)
    assert np.isfinite(y).all() and np.isfinite(h).all()
    jx = tuple(map(jnp.asarray, (a, g, h0)))
    for yr, hr in (jref.rglru_scan_ref(*jx),
                   jrglru_pallas(*jx, chunk=s, interpret=True)):
        np.testing.assert_allclose(y, np.asarray(yr), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(h, np.asarray(hr), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,r", [(1, 40), (63, 40), (65, 36), (129, 12),
                                 (300, 8)])
@pytest.mark.parametrize("kind", ["mixed", "one", "tiny", "alternating"])
def test_staged_bwd_emulation_from_checkpoints_matches_jax_vjp(s, r, kind):
    """The forward's checkpoint epilogue and the backward's staged route,
    emulated with the kernels' index math, S across piece edges, R over a
    partial last tile, the decays of the forward's emulation: every
    checkpoint, da, dg and dh0 written once, the checkpoints the
    reference's h_last over each 64p-step prefix, and the gradients
    ``jax.vjp``'s of the oracle within 1e-5 relative L2."""
    rng = np.random.default_rng(s * r)
    b = 2
    a = _decays(rng, b, s, r, kind)
    g = (rng.normal(size=(b, s, r)) * 0.2).astype(np.float32)
    h0 = rng.normal(size=(b, r)).astype(np.float32)
    dy = rng.normal(size=(b, s, r)).astype(np.float32)
    dh_last = rng.normal(size=(b, r)).astype(np.float32)
    _, _, ckpt = _staged_scan(a, g, h0, rg.STAGED)
    assert np.isfinite(ckpt).all()
    np.testing.assert_array_equal(ckpt[:, 0], h0)
    for p in range(1, ckpt.shape[1]):
        n = RGLRU_PIECE * p
        _, h_last = jref.rglru_scan_ref(*map(jnp.asarray,
                                             (a[:, :n], g[:, :n], h0)))
        np.testing.assert_allclose(ckpt[:, p], np.asarray(h_last),
                                   rtol=1e-5, atol=1e-5)
    got = _staged_bwd(a, g, ckpt, dy, dh_last, rg.BWD_STAGED)
    _, vjp = jax.vjp(jref.rglru_scan_ref, *map(jnp.asarray, (a, g, h0)))
    expect = vjp((jnp.asarray(dy), jnp.asarray(dh_last)))
    for name, x, e in zip(("da", "dg", "dh0"), got, expect):
        assert np.isfinite(x).all(), name
        e = np.asarray(e)
        norm = max(float(np.linalg.norm(e)), 1.0)
        assert float(np.linalg.norm(x - e)) / norm <= 1e-5, name


class _OffDevice:
    """A stand-in for a tensor on a device the kernels do not run on."""

    def __init__(self, t):
        self.shape, self.dtype, self.requires_grad = t.shape, t.dtype, False
        self.device = torch.device("xla")
        self.dim = t.dim


def test_scan_raises_off_cpu_and_cuda():
    """meta tensors take the kernel's route up to the launch (shapes, no
    launch); any other device raises."""
    a, g, h0 = map(_t, _scan_inputs(np.random.default_rng(7), 1, 4, 8))
    y, h_last = rglru_scan(*(x.to("meta") for x in (a, g, h0)))
    assert (y.device.type, y.shape, h_last.shape) == ("meta", a.shape,
                                                      h0.shape)
    with pytest.raises(ValueError, match="CUDA, CPU or meta"):
        rglru_scan(*map(_OffDevice, (a, g, h0)))


def test_gates_range_holds_the_pointwise_chain_and_its_kernels_sum():
    """rg_lru runs its pointwise gates inside the GATES_SPAN profiler
    range, and profile_serve sums the kernels of the ops inside that range
    on its thread, and of no other op."""
    from types import SimpleNamespace as NS
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import profile_serve

    r = 8
    p = {k: torch.full((r,), 0.5) for k in
         ("a_gate_w", "a_gate_b", "i_gate_w", "i_gate_b", "lam")}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trglru.rg_lru(p, torch.ones(1, 3, r), torch.zeros(1, r))
    names = [e.name for e in prof.events()]
    assert trglru.GATES_SPAN in names and "aten::sigmoid" in names
    # opened by the program's span helper: no user annotation, which the
    # trace would repeat on the device timeline
    gates = [e for e in prof.events() if e.name == trglru.GATES_SPAN]
    assert gates and not any(e.is_user_annotation for e in gates)

    def ev(name, thread, lo, hi, kernels=(), dev=DeviceType.CPU):
        return NS(name=name, thread=thread, device_type=dev,
                  time_range=NS(start=lo, end=hi),
                  kernels=[NS(duration=d) for d in kernels])

    span = trglru.GATES_SPAN
    fake = NS(events=lambda: [
        ev(span, 1, 0, 10), ev(span, 1, 20, 30),
        ev("aten::sigmoid", 1, 1, 2, (3.0,)),
        ev("aten::exp", 1, 21, 29, (4.0, 1.0)),
        ev("aten::mm", 1, 11, 19, (100.0,)),           # between the ranges
        ev("aten::mul", 2, 1, 2, (50.0,)),             # another thread
        ev(span, 0, 0, 10, (7.0,), DeviceType.CUDA)])  # the device copy
    assert profile_serve.span_device_s(fake, span) == (8e-6, 3, 2)


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


@pytest.mark.parametrize("n", [5, 16, 23, 32])
def test_decode_on_a_linear_cache_above_the_window_matches_reference(
        weights, n):
    """A caller-built linear cache of 2 x window rows: the new token is
    written at row n - 1 and attends the last ``window`` positions, as
    the reference's ``attn_block_decode`` does."""
    jcfg, tcfg, jparams, tparams = weights
    window = tcfg.local_window
    rng = np.random.default_rng(n)
    x = rng.normal(size=(2, 1, tcfg.d_model)).astype(np.float32)
    shape = (2, 2 * window, tcfg.n_kv_heads, tcfg.hd)
    kc, vc = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    jp = jax.tree.map(lambda a: a[0], jparams["super"]["attn"]["attn"])
    jout, jk, jv = jlm.attn_block_decode(
        jcfg, jp, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(n), jnp.full((1, 1), n - 1), window=window)
    tk, tv = _t(kc), _t(vc)
    tout = tlm.attn_block_decode(
        tcfg, tparams["super"][0]["attn"]["attn"], _t(x), tk, tv, n,
        torch.full((1, 1), n - 1), window=window)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)


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
        tapi.init(dataclasses.replace(tcfg, family="diffusion"), "cpu")
