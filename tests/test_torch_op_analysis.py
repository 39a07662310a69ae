"""The port's counted cost (``launch/op_analysis.py``) against the JAX
reference's HLO cost model (``repro/launch/hlo_analysis.py``), the hand
kernels' meta routes and cost functions, and the dry-run record's counted
fields (``launch/dryrun.py``).

The reference counts the FLOPs of XLA's compiled program, the port those
of its eager aten ops plus the hand kernels' reported costs.  Every FLOP
comparison is exact: the counts are sums of integers below 2^53.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import common as jcommon  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.hlo_analysis import analyze as janalyze  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.common import concrete_batch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import matmul_qi8 as mq  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rw  # noqa: E402
from repro_torch.launch import dryrun, mesh  # noqa: E402
from repro_torch.launch import op_analysis as oa  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402

CPU, META = torch.device("cpu"), torch.device("meta")


# ---------------------------------------------------------------------------
# (a) the reference's two HLO tests, counted by both
# ---------------------------------------------------------------------------
def test_single_matmul_equals_reference():
    n = 128
    x = jax.ShapeDtypeStruct((n, n), jnp.float32)
    expect = janalyze(jax.jit(lambda a, b: a @ b).lower(x, x).compile()
                      .as_text()).flops
    a = torch.empty(n, n)
    got = oa.analyze(lambda a, b: a @ b, a, a)
    assert got.flops == expect == 2 * n ** 3
    assert got.aten_flops == got.flops and got.kernels == {}


def test_loop_counted_at_every_trip_equals_reference():
    """The reference scales a while body by its trip count; an eager loop
    is counted at every trip."""
    n, trips = 64, 12

    def jf(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, None, length=trips)[0]

    def tf(x, w):
        for _ in range(trips):
            x = torch.tanh(x @ w)
        return x

    x = jax.ShapeDtypeStruct((n, n), jnp.float32)
    expect = janalyze(jax.jit(jf).lower(x, x).compile().as_text()).flops
    for dev in (CPU, META):
        a = torch.empty(n, n, device=dev)
        assert oa.analyze(tf, a, a).flops == expect == trips * 2 * n ** 3


# ---------------------------------------------------------------------------
# (b) bytes: views move nothing, an op reads its operands and writes once
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_bytes_of_views_and_elementwise_ops(dev):
    n = 1000
    a, b = torch.ones(n, device=dev), torch.ones(n, device=dev)
    for view in (lambda a, b: a.view(10, 100), lambda a, b: a[3:],
                 lambda a, b: a.reshape(100, 10).t(),
                 lambda a, b: a.expand(4, n)):
        t = oa.analyze(view, a, b)
        assert (t.hbm_bytes, t.flops, t.ops) == (0, 0, {})
    out = torch.empty(n, device=dev)
    for op in (lambda a, b: a + b, lambda a, b: a.add_(b),
               lambda a, b: torch.add(a, b, out=out)):
        t = oa.analyze(op, a, b)
        assert t.hbm_bytes == 3 * n * 4 and t.flops == 0
    t = oa.analyze(lambda a: torch.empty_like(a), a)
    assert t.hbm_bytes == 0
    assert t.coll_bytes == 0 and t.coll_by_kind == dict.fromkeys(
        oa.COLLECTIVES, 0.0) and t.coll_counts == t.coll_by_kind


def test_cost_totals_add_and_scale():
    a = oa.CostTotals(1.0, 2.0, 0.0, dict.fromkeys(oa.COLLECTIVES, 0.0),
                      dict.fromkeys(oa.COLLECTIVES, 0.0), 1.0,
                      {"k": {"launches": 1, "flops": 3.0, "bytes": 4.0}},
                      {"aten.mm.default": {"calls": 1, "flops": 1.0,
                                           "bytes": 2.0}})
    two = a + a
    assert two == a.scaled(2)
    assert two.kernels["k"] == {"launches": 2, "flops": 6.0, "bytes": 8.0}
    assert two.flops == 2.0 and two.hbm_bytes == 4.0


# ---------------------------------------------------------------------------
# (c) each kernel's meta route and reported cost
# ---------------------------------------------------------------------------
def _on(dev, *xs):
    return [x.to(dev) for x in xs]


def _pairs(s, t, causal, window):
    """Unmasked pairs by enumeration: query i sees keys up to t - s + i,
    the last ``window`` of them."""
    if not causal:
        return s * t
    return sum(min(t - s + i + 1, window or t) for i in range(s))


def _both(fn, *xs):
    """fn on CPU and on meta copies of xs -> (cpu out, meta out, meta
    count), every launch count 0 after."""
    _build.reset_launches()
    cpu = fn(*xs)
    meta, t = oa.counted(fn, *_on(META, *xs))
    assert all(_build.launches(k) == 0 for k in (
        "flash_attention", "flash_attention_bwd", "flash_decode",
        "rwkv6_scan", "rwkv6_scan_bwd", "rglru_scan", "rglru_scan_bwd",
        "matmul_qi8"))
    return cpu, meta, t


def _same_meta(cpu, meta):
    cpu = cpu if isinstance(cpu, (tuple, list)) else (cpu,)
    meta = meta if isinstance(meta, (tuple, list)) else (meta,)
    assert len(cpu) == len(meta)
    for c, m in zip(cpu, meta):
        assert m.device.type == "meta"
        assert (m.shape, m.dtype) == (c.shape, c.dtype)


ATTN_CASES = [  # b, hq, hkv, s, t, d, dtype, causal, window
    (2, 4, 2, 64, 64, 32, torch.float32, True, None),
    (1, 8, 1, 16, 48, 64, torch.bfloat16, True, 20),
    (2, 2, 2, 24, 40, 16, torch.float32, False, None),
    (1, 2, 2, 64, 64, 16, torch.float32, True, 20),
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_meta_route_and_cost(case):
    b, hq, hkv, s, t, d, dtype, causal, window = case
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, hq, s, d, generator=g).to(dtype)
    k, v = (torch.randn(b, hkv, t, d, generator=g).to(dtype)
            for _ in range(2))
    assert fa.attention_pairs(s, t, causal, window) == _pairs(
        s, t, causal, window)
    pairs = _pairs(s, t, causal, window) * b * hq
    size = q.element_size()
    io = (2 * b * hq * s * d + 2 * b * hkv * t * d) * size
    cpu, meta, cnt = _both(lambda *x: fa.flash_attention(
        *x, causal=causal, window=window), q, k, v)
    _same_meta(cpu, meta)
    assert cnt.kernels == {"flash_attention": {
        "launches": 1, "flops": 4 * d * pairs, "bytes": io}}
    # under autograd: the forward writes lse; the backward's gradients
    lse_bytes = 4 * b * hq * s
    bwd_bytes = ((3 * b * hq * s * d + 4 * b * hkv * t * d) * size
                 + lse_bytes)

    def grads(q, k, v):
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        return torch.autograd.grad(out.float().sum(), (q, k, v))

    cpu, meta, cnt = _both(grads, q, k, v)
    _same_meta(cpu, meta)
    assert cnt.kernels == {
        "flash_attention": {"launches": 1, "flops": 4 * d * pairs,
                            "bytes": io + lse_bytes},
        "flash_attention_bwd": {"launches": 1, "flops": 10 * d * pairs,
                                "bytes": bwd_bytes}}
    # the backward's wrapper alone, with the plain forward's lse
    lse = fa.flash_attention_ref(q, k, v, causal, window, True)[1]
    do = torch.randn(b, hq, s, d, generator=g).to(dtype)
    cpu, meta, cnt = _both(lambda *x: fa.flash_attention_bwd(
        *x, causal=causal, window=window), q, k, v, lse, do)
    _same_meta(cpu, meta)
    assert cnt.kernels["flash_attention_bwd"]["bytes"] == bwd_bytes


@pytest.mark.parametrize("case", [(2, 8, 2, 64, 32, torch.float32),
                                  (3, 4, 4, 96, 16, torch.bfloat16)])
def test_flash_decode_meta_route_and_cost(case):
    b, hq, hkv, t, d, dtype = case
    g = torch.Generator().manual_seed(1)
    q = torch.randn(b, hq, d, generator=g).to(dtype)
    k, v = (torch.randn(b, hkv, t, d, generator=g).to(dtype)
            for _ in range(2))
    size = q.element_size()
    for length, positions in ((t - 5, b * (t - 5)), (t + 7, b * t)):
        cpu, meta, cnt = _both(lambda *x: fd.flash_decode(*x, length),
                               q, k, v)
        _same_meta(cpu, meta)
        assert cnt.kernels == {"flash_decode": {
            "launches": 1, "flops": 4 * d * hq * positions,
            "bytes": (2 * b * hq * d + 2 * hkv * positions * d) * size}}
    # a (B,) length tensor: read on the host where it has values
    lens = torch.arange(b, dtype=torch.int32) * 5 + 3
    _, cnt = oa.counted(fd.flash_decode, q, k, v, lens)
    assert cnt.kernels == {}            # the CPU route: plain aten ops
    assert fd.valid_positions(lens, b, t) == int(lens.sum())
    assert fd.valid_positions(lens.to(META), b, t) == b * t


@pytest.mark.parametrize("case", [(2, 3, 19, 16, torch.float32),
                                  (1, 2, 8, 32, torch.bfloat16)])
def test_rwkv6_scan_meta_route_and_cost(case):
    b, h, s, d, dtype = case
    g = torch.Generator().manual_seed(2)
    r, k, v = (torch.randn(b, h, s, d, generator=g).to(dtype)
               for _ in range(3))
    w = torch.rand(b, h, s, d, generator=g).to(dtype)
    u = torch.randn(h, d, generator=g)
    s0 = torch.randn(b, h, d, d, generator=g)
    size = r.element_size()
    pieces = math.ceil(s / 8)
    fwd = (4 * b * h * s * d * d,
           5 * b * h * s * d * size + 2 * b * h * d * d * 4 + h * d * 4)
    cpu, meta, cnt = _both(rw.rwkv6_scan, r, k, v, w, u, s0)
    _same_meta(cpu, meta)
    assert cnt.kernels == {"rwkv6_scan": {"launches": 1, "flops": fwd[0],
                                          "bytes": fwd[1]}}
    states = 4 * b * h * pieces * d * d
    bwd = (8 * b * h * s * d * d,
           9 * b * h * s * d * size + 3 * b * h * d * d * 4 + 2 * h * d * 4
           + states)

    def grads(*xs):
        xs = [x.requires_grad_() for x in xs]
        y, s_last = rw.rwkv6_scan(*xs)
        if y.device.type == "meta":     # the card's layout and states
            assert y.stride() == torch.empty(
                b, s, h, d, device=META).transpose(1, 2).stride()
            saved = y.grad_fn.saved_tensors[-1]
            assert (saved.shape, saved.dtype) == (
                (b, h, pieces, d, d), torch.float32)
        return torch.autograd.grad(y.float().sum() + s_last.sum(), xs)

    cpu, meta, cnt = _both(grads, r, k, v, w, u, s0)
    _same_meta(cpu, meta)
    assert cnt.kernels == {
        "rwkv6_scan": {"launches": 1, "flops": fwd[0],
                       "bytes": fwd[1] + states},
        "rwkv6_scan_bwd": {"launches": 1, "flops": bwd[0],
                           "bytes": bwd[1]}}
    # the bound is the function's floor: without the kernel's checkpoints
    assert rw.scan_bwd_cost(r) == (bwd[0], bwd[1] - states)


@pytest.mark.parametrize("case", [(2, 70, 24, torch.float32),
                                  (3, 5, 40, torch.bfloat16)])
def test_rglru_scan_meta_route_and_cost(case):
    b, s, r, dtype = case
    g = torch.Generator().manual_seed(3)
    a = torch.rand(b, s, r, generator=g).to(dtype)
    x = torch.randn(b, s, r, generator=g).to(dtype)
    h0 = torch.randn(b, r, generator=g)
    size = a.element_size()
    cpu, meta, cnt = _both(rg.rglru_scan, a, x, h0)
    _same_meta(cpu, meta)
    fwd = {"launches": 1, "flops": 2 * b * s * r,
           "bytes": 3 * b * s * r * size + 2 * b * r * 4}
    assert cnt.kernels == {"rglru_scan": fwd}
    ckpt = 4 * b * -(-s // 64) * r      # the (B, ceil(S/64), R) checkpoints
    bwd = {"launches": 1, "flops": 3 * b * s * r,
           "bytes": 5 * b * s * r * size + 3 * b * r * 4 + ckpt}

    def grads(*xs):
        xs = [t.requires_grad_() for t in xs]
        y, h_last = rg.rglru_scan(*xs)
        if y.device.type == "meta":     # the checkpoints saved, not y
            saved = y.grad_fn.saved_tensors[-1]
            assert (saved.shape, saved.dtype) == (
                (b, -(-s // 64), r), torch.float32)
        return torch.autograd.grad(y.float().sum() + h_last.sum(), xs)

    cpu, meta, cnt = _both(grads, a, x, h0)
    _same_meta(cpu, meta)
    assert cnt.kernels == {
        "rglru_scan": {**fwd, "bytes": fwd["bytes"] + ckpt},
        "rglru_scan_bwd": bwd}
    # the bound is the function's floor: without the kernel's checkpoints
    assert rg.scan_bwd_cost(a) == (bwd["flops"], bwd["bytes"] - ckpt)


@pytest.mark.parametrize("mkn", [(8, 2048, 1000), (300, 30, 70)])
def test_matmul_qi8_meta_route_and_cost(mkn):
    m, k, n = mkn
    g = torch.Generator().manual_seed(4)
    x = torch.randint(-128, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=g, dtype=torch.int8)
    cpu, meta, cnt = _both(mq.matmul_qi8, x, w)
    _same_meta(cpu, meta)
    assert cnt.kernels == {"matmul_qi8": {
        "launches": 1, "flops": 2 * m * n * k,
        "bytes": m * k + k * n + 4 * m * n}}


# ---------------------------------------------------------------------------
# (d), (e), (f) the smoke train steps
# ---------------------------------------------------------------------------
B, S, CHUNK = 2, 64, 32
STEP_CASES = [(arch, remat) for arch in ("qwen3-1.7b", "granite-moe-1b-a400m")
              for remat in (False, True)]


def _ref_flops(arch, remat):
    """The reference's HLO FLOPs of its jitted train step (hlo_analysis)."""
    jcfg = dataclasses.replace(jconfigs.get(arch).smoke_config(), remat=remat)
    params, opt = jsteps.train_state_shapes(jcfg)
    batch = jcommon.input_specs(jcfg, jcommon.ShapeSpec("t", S, B, "train"))
    step = jax.jit(jsteps.make_train_step(jcfg, jadamw.AdamWConfig(),
                                          loss_chunk=CHUNK))
    return janalyze(step.lower(params, opt, batch).compile().as_text()).flops


def _port_step(arch, remat, dev):
    cfg = dataclasses.replace(tconfigs.get(arch).smoke_config(), remat=remat)
    step = tsteps.make_train_step(cfg, AdamWConfig(), loss_chunk=CHUNK)
    if dev == META:
        params, opt = tsteps.train_state_shapes(cfg)
        batch = tconfigs.input_specs(cfg, tconfigs.ShapeSpec("t", S, B,
                                                             "train"))
    else:
        params, opt = tsteps.init_train_state(
            cfg, CPU, torch.Generator().manual_seed(0))
        batch = concrete_batch(cfg, S, B, rng=np.random.default_rng(0))
    return cfg, step, (params, opt, batch)


@pytest.fixture(scope="module")
def step_counts():
    """Each case's reference FLOPs, the port's CPU count and FlopCounterMode
    total, and its meta count and FlopCounterMode total."""
    out = {}
    for arch, remat in STEP_CASES:
        rec = {"ref": _ref_flops(arch, remat)}
        for dev in (CPU, META):
            cfg, step, args = _port_step(arch, remat, dev)
            rec[dev.type] = oa.analyze(step, *args)
            with FlopCounterMode(display=False) as fc:
                step(*args)
            rec[f"{dev.type}_flop_counter"] = fc.get_total_flops()
        rec["cfg"] = cfg
        out[arch, remat] = rec
    return out


@pytest.mark.parametrize("arch,remat", STEP_CASES)
def test_cpu_count_equals_reference_plus_the_plain_recompute(
        step_counts, arch, remat):
    """The CPU step runs the plain attention, whose backward recomputes
    P = softmax(Q K^T) (one product of 2*B*Hq*S*T*D a layer) where the
    reference's differentiated jnp keeps it: exactly that more."""
    rec = step_counts[arch, remat]
    cfg = rec["cfg"]
    qkt = 2 * B * cfg.n_heads * S * S * cfg.hd
    assert rec["cpu"].flops == rec["ref"] + cfg.n_layers * qkt
    assert rec["cpu"].kernels == {}


@pytest.mark.parametrize("arch,remat", STEP_CASES)
def test_aten_flops_equal_flop_counter_mode(step_counts, arch, remat):
    rec = step_counts[arch, remat]
    assert rec["cpu"].aten_flops == rec["cpu_flop_counter"]
    assert rec["meta"].aten_flops == rec["meta_flop_counter"]


@pytest.mark.parametrize("arch,remat", STEP_CASES)
def test_meta_count_is_the_cpu_count_with_the_kernels(step_counts, arch,
                                                      remat):
    """The plain attention's products (forward QK^T and P V, twice with
    remat; the backward's five) replaced by the kernels' reported FLOPs
    (4*D and 10*D per unmasked pair)."""
    rec = step_counts[arch, remat]
    cfg = rec["cfg"]
    full = 2 * B * cfg.n_heads * S * S * cfg.hd       # one S x T product
    fwd = 2 if remat else 1
    plain = cfg.n_layers * (fwd * 2 + 5) * full
    pairs = B * cfg.n_heads * S * (S + 1) // 2
    kernels = {"flash_attention": {
        "launches": fwd * cfg.n_layers,
        "flops": fwd * cfg.n_layers * 4 * cfg.hd * pairs},
        "flash_attention_bwd": {
        "launches": cfg.n_layers,
        "flops": cfg.n_layers * 10 * cfg.hd * pairs}}
    meta = rec["meta"]
    assert {k: {f: v[f] for f in ("launches", "flops")}
            for k, v in meta.kernels.items()} == kernels
    kernel_flops = sum(v["flops"] for v in kernels.values())
    assert meta.aten_flops == rec["cpu"].flops - plain
    assert meta.flops == rec["cpu"].flops - plain + kernel_flops


# ---------------------------------------------------------------------------
# (g) the dry-run record's counted fields
# ---------------------------------------------------------------------------
COUNTED = [("qwen3-1.7b", "train_4k", {"flash_attention": 56,
                                       "flash_attention_bwd": 28}),
           ("qwen3-1.7b", "prefill_32k", {"flash_attention": 28}),
           ("qwen3-1.7b", "decode_32k", {"flash_decode": 28}),
           ("rwkv6-1.6b", "train_4k", {"rwkv6_scan": 48,
                                       "rwkv6_scan_bwd": 24})]


@pytest.mark.parametrize("arch,shape,launches", COUNTED)
def test_one_card_record_carries_the_counted_fields(arch, shape, launches):
    rec = dryrun.dryrun_cell(arch, shape, mesh.GRIDS["1x1"], verbose=False)
    assert rec["status"] == "ok" and rec["counted"] == "meta"
    flops, nbytes = (rec["counted_flops_per_device"],
                     rec["counted_bytes_per_device"])
    kernels = rec["kernels"]
    assert {k: v["launches"] for k, v in kernels.items()} == launches
    assert flops == rec["aten_flops_per_device"] + sum(
        v["flops"] for v in kernels.values())
    assert rec["aten_flops_per_device"] > 0 and nbytes > sum(
        v["bytes"] for v in kernels.values())
    zeros = dict.fromkeys(oa.COLLECTIVES, 0.0)
    assert rec["collective_bytes_per_device"] == 0
    assert rec["collective_breakdown"] == rec["collective_counts"] == zeros
    terms = {"compute_s": flops / 989e12, "memory_s": nbytes / 3.35e12,
             "collective_s": 0.0}
    assert rec["roofline"] == dict(terms, dominant=max(terms,
                                                       key=terms.get))
    assert rec["useful_flops_ratio"] == rec["model_flops_global"] / flops
    assert rec["count_s"] > 0
    cfg = tconfigs.get(arch).config()
    spec = tconfigs.SHAPES[shape]
    if shape == "decode_32k":      # every row's cache holds seq_len
        assert kernels["flash_decode"]["flops"] == (
            cfg.n_layers * 4 * cfg.hd * cfg.n_heads * spec.global_batch
            * spec.seq_len)
    if shape == "train_4k" and arch == "qwen3-1.7b":
        pairs = spec.global_batch * cfg.n_heads * spec.seq_len * (
            spec.seq_len + 1) // 2
        assert kernels["flash_attention_bwd"]["flops"] == (
            cfg.n_layers * 10 * cfg.hd * pairs)


@pytest.mark.parametrize("grid", ["16x16", "2x16x16"])
def test_partitioned_records_carry_none_with_the_note(grid):
    rec = dryrun.dryrun_cell("qwen3-1.7b", "train_4k", mesh.GRIDS[grid],
                             verbose=False)
    assert all(rec[f] is None for f in dryrun.COUNTED_FIELDS)
    assert rec["counted"] == dryrun.NOT_PARTITIONED
    assert "partitioner" in rec["counted"]
    off = dryrun.dryrun_cell("qwen3-1.7b", "train_4k", mesh.GRIDS["1x1"],
                             verbose=False, count=False)
    assert all(off[f] is None for f in dryrun.COUNTED_FIELDS)
    assert off["counted"] == dryrun.NOT_COUNTED


def test_measure_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        dryrun.measure_cell(tconfigs.get("qwen3-1.7b").smoke_config(),
                            tconfigs.SHAPES["train_4k"],
                            dryrun.Reduced(2, 64))
