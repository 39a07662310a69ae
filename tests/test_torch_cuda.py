"""The port's CUDA kernels and CUDA paths against their plain versions.

Marked ``cuda``: they need a card of compute capability 9.0 or newer and
skip elsewhere.  This file imports no JAX, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 1e-4 in fp32 (summation order of the kernel's online softmax
against the materialized one; flash_decode, whose sums are shorter, 1e-5),
2e-2 in bf16 (one bf16 rounding of outputs of magnitude ~1; the bf16
flash_attention also rounds P to bf16 for the tensor cores).  The scans:
rtol = atol = 2e-4 (rwkv6_scan) and 1e-5 (rglru_scan) in fp32, 2e-2 in
bf16, the tolerances of the reference's own kernel tests.  matmul_qi8 and
the int8 API: exact.  The CNN forward: 1e-4 of max |y| against the CPU
(fp32, TF32 off; convolution algorithms sum in other orders).  The
flash-attention backward: each of dq, dk and dv within 1e-4 (fp32) or
2e-2 (bf16, which also rounds P and dS to bf16 for the tensor cores) of
its scale max(1, max |plain|), within 1e-5 (fp32) or 1e-2 (bf16)
relative L2 error (which a wrong bulk of rows moves even where causal
attention's first rows set the scale), and equal bit for bit from call
to call.  The scans' backwards: each gradient within the same two bounds
(fp32: summation order; bf16: one rounding of each gradient).
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api as tapi
from repro_torch import configs
from repro_torch.configs.common import concrete_batch
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import matmul_qi8 as mq
from repro_torch.kernels import quant
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rwkv6_scan as rw
from repro_torch.checkpoint.store import tree_map
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref, flash_decode_ref,
                                     matmul_qi8_ref, rglru_scan_bwd_ref,
                                     rglru_scan_ref, rwkv6_scan_bwd_ref,
                                     rwkv6_scan_ref)
from repro_torch.launch import serve
from repro_torch.models import api, cnn, lm, whisper

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture
def sm90():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernel is built for sm_90a")
    return torch.device("cuda")


def _attention_inputs(g, dev, b, hq, hkv, s, t, d, dtype, layout=False):
    """q/k/v, as (B, H, S, D) tensors or (``layout``) as (B, H, S, D)
    views of the model's (B, S, H, D) projections."""
    out = []
    for h, n in ((hq, s), (hkv, t), (hkv, t)):
        if layout:
            out.append(torch.randn(b, n, h, d, generator=g, device=dev,
                                   dtype=DTYPES[dtype]).transpose(1, 2))
        else:
            out.append(torch.randn(b, h, n, d, generator=g, device=dev,
                                   dtype=DTYPES[dtype]))
    return out


@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal,dtype,layout", [
    (1, 2, 2, 128, 128, 64, True, "float32", False),
    (2, 4, 2, 256, 256, 64, True, "float32", False),
    (1, 8, 1, 128, 256, 128, True, "float32", False),   # MQA, s != t
    (2, 2, 2, 128, 128, 64, False, "float32", False),
    (1, 4, 4, 256, 256, 64, True, "bfloat16", False),
    (2, 4, 1, 72, 200, 16, True, "float32", False),     # ragged
    (1, 2, 2, 24, 16, 32, False, "float32", False),     # non-causal, s > t
    (1, 16, 8, 1000, 1000, 128, True, "bfloat16", False),   # the slice's
    (1, 16, 8, 128, 1024, 128, True, "bfloat16", False),
    (2, 16, 1, 256, 256, 256, True, "bfloat16", False),     # MQA 16:1
    (1, 16, 1, 200, 200, 256, True, "float32", False),
    # bf16 on the tensor cores: every head dim, ragged S and T, S < T,
    # non-causal S > T, groups 1, 2, 16, the model layout
    (1, 2, 2, 1, 1, 16, True, "bfloat16", False),
    (2, 4, 1, 72, 200, 16, True, "bfloat16", False),
    (1, 4, 2, 17, 17, 32, True, "bfloat16", False),
    (1, 2, 2, 24, 16, 32, False, "bfloat16", False),
    (1, 4, 2, 100, 17, 64, False, "bfloat16", False),
    (1, 4, 4, 1000, 1000, 64, True, "bfloat16", False),
    (1, 16, 1, 17, 72, 128, True, "bfloat16", False),
    (2, 16, 8, 72, 72, 128, True, "bfloat16", True),
    (1, 16, 1, 1, 1000, 256, True, "bfloat16", False),
    (1, 16, 1, 1000, 1000, 256, True, "bfloat16", True),
    (2, 2, 1, 200, 72, 256, False, "bfloat16", False),
    # head dim 96 (phi3-mini: MHA, 32 heads): 12 16-byte chunks a row
    (1, 32, 32, 1024, 1024, 96, True, "bfloat16", True),
    (1, 32, 32, 1000, 1000, 96, True, "bfloat16", False),
    (1, 4, 2, 100, 17, 96, False, "bfloat16", False),
    (1, 32, 32, 257, 257, 96, True, "float32", True),
    (2, 4, 1, 72, 200, 96, True, "float32", False),
])
def test_kernel_matches_plain(sm90, b, hq, hkv, s, t, d, causal, dtype,
                              layout):
    g = torch.Generator(sm90).manual_seed(0)
    q, k, v = _attention_inputs(g, sm90, b, hq, hkv, s, t, d, dtype, layout)
    before = _build.launches("flash_attention")
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _build.launches("flash_attention") == before + 1
    expect = flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), expect.float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_kernel_reads_and_writes_model_layout(sm90):
    # (B, S, H, D) projections passed as (B, H, S, D) views
    g = torch.Generator(sm90).manual_seed(1)
    q, k, v = (torch.randn(1, 300, h, 128, generator=g, device=sm90,
                           dtype=torch.bfloat16).transpose(1, 2)
               for h in (16, 8, 8))
    got = fa.flash_attention(q, k, v)
    assert got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got.float(), flash_attention_ref(q, k, v)
                               .float(), rtol=2e-2, atol=2e-2)


def test_bf16_kernel_rejects_misaligned_rows(sm90):
    """The bf16 route copies 16-byte rows: a view one element into its
    storage raises, and nothing falls back."""
    n = 1 * 2 * 64 * 64
    q = torch.randn(n + 1, device=sm90, dtype=torch.bfloat16)[1:].view(
        1, 2, 64, 64)
    k = torch.randn(1, 2, 64, 64, device=sm90, dtype=torch.bfloat16)
    before = _build.launches("flash_attention")
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention(q, k, k)
    assert _build.launches("flash_attention") == before


def test_smoke_forward_matches_cpu(sm90):
    cfg = configs.get("qwen3-1.7b").smoke_config()
    cpu = torch.device("cpu")
    params = lm.init_params(cfg, cpu, torch.Generator(cpu).manual_seed(0))
    on_card = {"embed": params["embed"].to(sm90),
               "final_norm": {"scale": params["final_norm"]["scale"].to(sm90)},
               "blocks": [{k: {n: w.to(sm90) for n, w in sub.items()}
                           for k, sub in bp.items()}
                          for bp in params["blocks"]]}
    batch = concrete_batch(cfg, 200, 2, kind="prefill")
    got = lm.forward(cfg, on_card, batch)
    expect = lm.forward(cfg, params, batch)
    torch.testing.assert_close(got.cpu(), expect, rtol=1e-4, atol=1e-4)


def test_serve_smoke_on_card(sm90):
    _build.reset_launches()
    res = serve.run(serve.parse_args(["--smoke", "--stages", "3",
                                      "--requests", "4", "--seq", "100"]))
    assert (_build.launches("flash_attention")
            == res["cfg"].n_layers * (4 + 2))
    assert res["max_err"] < 2e-2
    assert all(torch.isfinite(o).all() for o in res["outs"])


@pytest.mark.parametrize("b,hq,hkv,t,d,lens,dtype", [
    (8, 16, 8, 2048, 128, [0, 1, 127, 128, 1000, 1088, 2047, 2048],
     "bfloat16"),                                   # the decode path
    (8, 16, 8, 2048, 128, [0, 1, 127, 128, 1000, 1088, 2047, 2048],
     "float32"),
    (4, 8, 1, 1000, 64, [1, 255, 999, 1000], "float32"),        # MQA
    (2, 4, 2, 300, 16, 200, "bfloat16"),            # smoke widths, scalar
    (2, 8, 2, 96, 32, [96, 95], "float32"),         # one split
    (3, 6, 2, 520, 64, [519, 3, 260], "bfloat16"),  # group 3
    (2, 4, 4, 256, 64, 1000, "float32"),            # length past T
    (2, 16, 1, 64, 256, [64, 33], "bfloat16"),      # recurrentgemma ring
    (3, 16, 1, 600, 256, [1, 599, 300], "float32"),  # group 16, D 256
    # the tensor-core route's split plan: lengths of 0 and ending inside
    # a split, at recurrentgemma's decode loop, its full window and qwen3's
    (16, 16, 1, 64, 256, [0, 1, 15, 16, 17, 33, 63, 64] * 2, "bfloat16"),
    (16, 16, 1, 2048, 256, [2048] * 8 + [0, 1, 100, 127, 129, 1000, 2047,
                                         2048], "bfloat16"),
    (8, 16, 8, 2048, 128, [0, 200, 223, 225, 500, 1056, 1057, 1999],
     "bfloat16"),
    (2, 40, 2, 300, 64, [300, 17], "bfloat16"),     # group 20: two blocks
    # head dim 96 (phi3-mini's decode point, group 1), lengths ending
    # inside a split; fp32 at 8 lanes a row, 3 slices a lane
    (8, 32, 32, 2048, 96, [0, 1, 127, 128, 1000, 1056, 2047, 2048],
     "bfloat16"),
    (8, 32, 32, 2048, 96, [0, 200, 223, 225, 500, 1056, 1057, 1999],
     "float32"),
    (2, 8, 2, 300, 96, [300, 17], "bfloat16"),      # group 4
    (2, 16, 2, 300, 96, [300, 17], "float32"),      # two blocks of 4 heads
])
def test_flash_decode_matches_plain(sm90, b, hq, hkv, t, d, lens, dtype):
    g = torch.Generator(sm90).manual_seed(0)
    q = torch.randn(b, hq, d, generator=g, device=sm90, dtype=DTYPES[dtype])
    # caches in the engine's (B, T, Hkv, D) layout, passed as views
    k, v = (torch.randn(b, t, hkv, d, generator=g, device=sm90,
                        dtype=DTYPES[dtype]).transpose(1, 2)
            for _ in range(2))
    arg = (lens if isinstance(lens, int)
           else torch.tensor(lens, dtype=torch.int32, device=sm90))
    before = _build.launches("flash_decode")
    got = fd.flash_decode(q, k, v, arg)
    torch.cuda.synchronize()
    assert _build.launches("flash_decode") == before + 1
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(),
                               flash_decode_ref(q, k, v, arg).float(),
                               rtol=tol, atol=tol)
    live = torch.as_tensor(lens, device=sm90).expand(b) > 0
    assert not got[~live].any()


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "minitron-4b",
                                  "phi3-mini-3.8b", "granite-moe-1b-a400m",
                                  "phi3.5-moe-42b-a6.6b", "qwen2-vl-72b"])
def test_family_smoke_forward_and_decode_match_cpu(sm90, arch):
    """The LM families' smoke configs (fp32) on the card against the CPU:
    the forward of a (2, 40) batch (vlm: after its patches) and 8 decode
    steps after a prefill of it, within 1e-4."""
    import dataclasses
    cfg = configs.get(arch).smoke_config()
    if arch == "phi3-mini-3.8b":
        cfg = dataclasses.replace(cfg, head_dim=96)   # the D 96 kernels
    cpu = torch.device("cpu")
    params = api.init(cfg, cpu, torch.Generator(cpu).manual_seed(0))
    card = _to(params, sm90)
    batch = concrete_batch(cfg, 40 + cfg.n_patches, 2, kind="prefill")
    out = []
    for dev, p in ((cpu, params), (sm90, card)):
        cache = api.init_cache(cfg, 2, 64 + cfg.n_patches, dev)
        logits, cache = api.prefill(cfg, p, _to(batch, dev), cache)
        rows = [logits]
        for _ in range(8):
            tok = rows[-1][:, -1:].argmax(-1)
            step, cache = api.decode(cfg, p, tok, cache)
            rows.append(step)
        out.append(torch.cat(rows, 1).cpu())
    torch.testing.assert_close(out[1], out[0], rtol=1e-4, atol=1e-4)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def test_flash_decode_rejects_unaligned_rows(sm90):
    q = torch.randn(1, 2, 16, device=sm90)
    k = torch.randn(1, 2, 64, 17, device=sm90)[..., :16]   # rows 68 B apart
    with pytest.raises(ValueError, match="16-byte aligned"):
        fd.flash_decode(q, k, k, 4)


def test_smoke_decode_engine_on_card_matches_cpu(sm90):
    from repro_torch.decode.engine import PipelineDecodeEngine
    cfg = configs.get("qwen3-1.7b").smoke_config()
    cpu = torch.device("cpu")
    params = lm.init_params(cfg, cpu, torch.Generator(cpu).manual_seed(0))
    on_card = {"embed": params["embed"].to(sm90),
               "final_norm": {"scale": params["final_norm"]["scale"].to(sm90)},
               "blocks": [{k: {n: w.to(sm90) for n, w in sub.items()}
                           for k, sub in bp.items()}
                          for bp in params["blocks"]]}
    prompt = np.asarray([3, 1, 4, 1, 5, 9, 2, 6], np.int32)
    streams = []
    for p in (params, on_card):
        eng = PipelineDecodeEngine(cfg, p, n_slots=3, max_context=300,
                                   stage_blocks=[1, 3])
        with eng:
            tok = eng.prefill(2, prompt)
            got, ctx = [tok], prompt.size + 1
            while len(got) < 6:
                tok = eng.step([2], [ctx], [tok])[0]
                ctx += 1
                got.append(tok)
        streams.append(got)
    assert streams[0] == streams[1]


@pytest.mark.parametrize("b,h,s,d,dtype,layout", [
    (4, 32, 300, 64, "float32", True),              # rwkv6-1.6b widths
    (4, 32, 1, 64, "float32", True),                # the decode step
    (2, 4, 129, 64, "bfloat16", False),
    (2, 3, 70, 32, "float32", False),
    (1, 2, 40, 16, "bfloat16", True),
])
def test_rwkv6_scan_matches_plain(sm90, b, h, s, d, dtype, layout):
    g = torch.Generator(sm90).manual_seed(0)

    def x(scale=1.0):
        shape = (b, s, h, d) if layout else (b, h, s, d)
        t = (scale * torch.randn(shape, generator=g, device=sm90)).to(
            DTYPES[dtype])
        return t.transpose(1, 2) if layout else t

    w = (0.7 + 0.3 * torch.rand(b, h, s, d, generator=g, device=sm90)).to(
        DTYPES[dtype])
    args = (x(), x(0.2), x(), w,
            0.2 * torch.randn(h, d, generator=g, device=sm90),
            0.1 * torch.randn(b, h, d, d, generator=g, device=sm90))
    before = _build.launches("rwkv6_scan")
    y, s_last = rw.rwkv6_scan(*args)
    torch.cuda.synchronize()
    assert _build.launches("rwkv6_scan") == before + 1
    y_ref, s_ref = rwkv6_scan_ref(*args)
    tol = 2e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(s_last, s_ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("s", [1, 31, 1024])
def test_rwkv6_scan_extreme_decays_match_plain(sm90, s):
    """Decays at both ends of (0, 1], 1e-30 and 1, on alternate steps and
    channels: the step recurrence is exact for any w."""
    b, h, d = 4, 32, 64
    g = torch.Generator(sm90).manual_seed(3)

    def x(scale=1.0):
        return (scale * torch.randn(b, s, h, d, generator=g, device=sm90)
                ).transpose(1, 2)

    w = torch.ones(b, s, h, d, device=sm90)
    w[:, 0::2, :, 0::2] = 1e-30
    w[:, 1::2, :, 1::2] = 1e-30
    args = (x(), x(0.2), x(), w.transpose(1, 2),
            0.2 * torch.randn(h, d, generator=g, device=sm90),
            0.1 * torch.randn(b, h, d, d, generator=g, device=sm90))
    y, s_last = rw.rwkv6_scan(*args)
    torch.cuda.synchronize()
    y_ref, s_ref = rwkv6_scan_ref(*args)
    torch.testing.assert_close(y, y_ref, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s_last, s_ref, rtol=2e-4, atol=2e-4)


def test_rwkv6_scan_rejects_unaligned_rows(sm90):
    r = torch.randn(1, 2, 8, 17, device=sm90)[..., :16]    # rows 68 B apart
    with pytest.raises(ValueError, match="16-byte aligned"):
        rw.rwkv6_scan(r, r, r, r, torch.zeros(2, 16, device=sm90),
                      torch.zeros(1, 2, 16, 16, device=sm90))


@pytest.mark.parametrize("b,s,r,dtype", [
    (2, 512, 4096, "float32"),                      # recurrentgemma widths
    (2, 1, 4096, "float32"),                        # the decode step
    (3, 100, 1000, "bfloat16"),                     # ragged channels
    (16, 1, 4096, "float32"),                       # the decode loop's rows
    (2, 63, 4096, "float32"),                       # the route threshold
    (2, 64, 4096, "float32"),
    (2, 65, 4096, "float32"),                       # piece edges
    (2, 129, 4096, "float32"),
    (1, 127, 2048, "float32"),
    (1, 257, 2048, "float32"),
    (1, 4096, 4096, "float32"),                     # above the 2048 window
    (1, 4096, 4096, "bfloat16"),
    (2, 300, 1001, "float32"),                      # rows off 16 bytes
])
def test_rglru_scan_matches_plain(sm90, b, s, r, dtype):
    g = torch.Generator(sm90).manual_seed(0)
    a = (0.3 + 0.7 * torch.rand(b, s, r, generator=g, device=sm90)).to(
        DTYPES[dtype])
    x = (0.2 * torch.randn(b, s, r, generator=g, device=sm90)).to(
        DTYPES[dtype])
    h0 = torch.randn(b, r, generator=g, device=sm90)
    before = _build.launches("rglru_scan")
    y, h = rg.rglru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert _build.launches("rglru_scan") == before + 1
    y_ref, h_ref = rglru_scan_ref(a, x, h0)
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, h_ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("b,s,r", [(2, 1024, 4096), (1, 4096, 4096),
                                   (2, 40, 4096)])
def test_rglru_scan_extreme_decays_match_plain(sm90, b, s, r):
    """Decays of exactly 1 on even channels (a running sum over all of S)
    and 1e-30 and 1 on alternate steps of odd channels: the kernel keeps
    the recurrence's order, so it holds the fp32 tolerance at any S, with
    one counted launch."""
    g = torch.Generator(sm90).manual_seed(2)
    a = torch.ones(b, s, r, device=sm90)
    a[:, 0::2, 1::2] = 1e-30
    x = 0.2 * torch.randn(b, s, r, generator=g, device=sm90)
    h0 = torch.randn(b, r, generator=g, device=sm90)
    before = _build.launches("rglru_scan")
    y, h = rg.rglru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert _build.launches("rglru_scan") == before + 1
    y_ref, h_ref = rglru_scan_ref(a, x, h0)
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, h_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,s,r,dtype", [(2, 1024, 4096, "float32"),
                                         (1, 4096, 4096, "bfloat16"),
                                         (3, 300, 1000, "bfloat16")])
def test_rglru_scan_staged_route_equals_step_route(sm90, b, s, r, dtype):
    """The two routes run the same FMAs in the same order: equal bits."""
    plan = rg.scan_plan(s, r, DTYPES[dtype].itemsize)
    assert plan.route == "staged"
    g = torch.Generator(sm90).manual_seed(4)
    a = (0.3 + 0.7 * torch.rand(b, s, r, generator=g, device=sm90)).to(
        DTYPES[dtype])
    x = (0.2 * torch.randn(b, s, r, generator=g, device=sm90)).to(
        DTYPES[dtype])
    h0 = torch.randn(b, r, generator=g, device=sm90)
    y, h = rg.launch(a, x, h0, plan)
    y_step, h_step = rg.launch(a, x, h0, rg.STEP)
    torch.cuda.synchronize()
    assert torch.equal(y, y_step) and torch.equal(h, h_step)


def test_rglru_scan_rejects_non_contiguous_inputs(sm90):
    a = torch.rand(2, 4096, 128, device=sm90).transpose(1, 2)   # (2,128,4096)
    x = torch.zeros(2, 128, 4096, device=sm90)
    with pytest.raises(ValueError, match="contiguous"):
        rg.rglru_scan(a, x, torch.zeros(2, 4096, device=sm90))


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.parametrize("arch,seq,prompt_len,by_token", [
    ("rwkv6-1.6b", 100, 20, False), ("recurrentgemma-9b", 16, 6, True)])
def test_recurrent_smoke_models_on_card_match_cpu(sm90, arch, seq,
                                                  prompt_len, by_token):
    """Forward and a greedy decode loop (the hybrid's ring wraps at 24
    tokens over its smoke window of 16) on the card against the CPU."""
    cfg = configs.get(arch).smoke_config()
    cpu = torch.device("cpu")
    params = api.init(cfg, cpu, torch.Generator(cpu).manual_seed(0))
    on_card = _to(params, sm90)
    batch = concrete_batch(cfg, seq, 2, kind="prefill")
    torch.testing.assert_close(api.forward(cfg, on_card, batch).cpu(),
                               api.forward(cfg, params, batch),
                               rtol=1e-4, atol=1e-4)
    prompt = concrete_batch(cfg, prompt_len, 2, kind="prefill")["tokens"]
    runs = []
    for dev, p in ((cpu, params), (sm90, on_card)):
        cache = api.init_cache(cfg, 2, 24, dev)
        feed = ([prompt[:, i:i + 1] for i in range(prompt_len)]
                if by_token else [prompt])
        toks = []
        for i in range(24 - prompt_len + len(feed)):
            tok = feed[i] if i < len(feed) else toks[-1]
            logits, cache = api.decode(cfg, p, tok.to(dev), cache)
            toks.append(logits[:, -1].argmax(-1, keepdim=True).cpu())
        runs.append(torch.cat(toks, 1))
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("b,hq,hkv,s,t,d,window,dtype", [
    (1, 16, 1, 300, 300, 256, 128, "bfloat16"),     # recurrentgemma MQA
    (1, 16, 1, 200, 200, 256, 64, "float32"),
    (2, 4, 2, 130, 130, 64, 1, "float32"),          # each query alone
    (1, 4, 2, 100, 260, 128, 70, "float32"),        # right-aligned, ragged
    (1, 16, 8, 1000, 1000, 128, 2048, "bfloat16"),  # wider than T
    (2, 4, 2, 130, 130, 64, 1, "bfloat16"),         # each query alone
    (1, 4, 2, 100, 260, 128, 70, "bfloat16"),       # right-aligned, ragged
    (1, 16, 1, 17, 1000, 256, 33, "bfloat16"),
    (1, 2, 2, 72, 72, 32, 5000, "bfloat16"),        # wider than T
    (1, 2, 1, 1000, 1000, 16, 100, "bfloat16"),
])
def test_windowed_flash_attention_matches_plain(sm90, b, hq, hkv, s, t, d,
                                                window, dtype):
    g = torch.Generator(sm90).manual_seed(2)
    q, k, v = (torch.randn(shape, generator=g, device=sm90,
                           dtype=DTYPES[dtype])
               for shape in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d)))
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    expect = flash_attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), expect.float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("m,k,n", [
    (512, 512, 512), (8, 2048, 1000), (25088, 64, 256), (7, 30, 13),
    (1, 1, 1), (65, 129, 63), (3, 0, 5),
    # split-K over the 16-row tile, the head's N
    (1, 2048, 1000), (16, 2048, 1000), (1, 4096, 1000), (8, 4096, 1000),
    (16, 4096, 1000),
    # ragged K through the byte loaders, split and not
    (8, 30, 1000), (16, 129, 64), (300, 129, 1000), (1000, 30, 300),
])
def test_matmul_qi8_is_exact_on_card(sm90, m, k, n):
    """Exact against the plain version (float64 on the card, exact for
    these sums) and the CPU's int32 product; the extremes -128 x -128 must
    not wrap."""
    g = torch.Generator(sm90).manual_seed(m + k + n)
    x = torch.randint(-128, 128, (m, k), generator=g, device=sm90,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=g, device=sm90,
                      dtype=torch.int8)
    if k:
        x[0], w[:, 0] = -128, -128
    before = _build.launches("matmul_qi8")
    got = mq.matmul_qi8(x, w)
    torch.cuda.synchronize()
    assert _build.launches("matmul_qi8") == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, matmul_qi8_ref(x, w))
    assert torch.equal(got.cpu(), matmul_qi8_ref(x.cpu(), w.cpu()))


def test_quantized_dense_on_card_equals_cpu(sm90):
    g = torch.Generator("cpu").manual_seed(3)
    x, w = torch.randn(8, 2048, generator=g), torch.randn(2048, 1000,
                                                           generator=g)
    got = quant.quantized_dense(x.to(sm90), w.to(sm90))
    assert torch.equal(got.cpu(), quant.quantized_dense(x, w))


@pytest.mark.parametrize("name", ["MobileNetV2", "InceptionV3"])
def test_cnn_forward_on_card_matches_cpu(sm90, name):
    """fp32 with TF32 off, as the reference's function: 1e-4 of max |y|
    (cuDNN's and the CPU's convolution algorithms sum in other orders)."""
    m = cnn.REAL_CNNS[name]()
    cpu = torch.device("cpu")
    params = m.init(cpu, torch.Generator(cpu).manual_seed(0))
    x = torch.randn((1,) + m.input_shape,
                    generator=torch.Generator(cpu).manual_seed(1))
    expect = m.apply(params, x)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        got = m.apply(_to(params, sm90), x.to(sm90)).cpu()
    err = (got - expect).abs().max().item()
    assert err <= 1e-4 * expect.abs().max().item()


def test_cnn_served_on_card_equals_direct(sm90):
    m = cnn.synthetic_cnn(32, hw=32)
    params = m.init(sm90, torch.Generator(sm90).manual_seed(0))
    dep = tapi.deploy(
        tapi.DeploymentSpec(model="synthetic-cnn:32", stages=3),
        graph=m.to_layer_graph(),
        stage_fn_builder=lambda p: serve.cnn_stage_fns(m, params, p, sm90))
    xs = [torch.randn(1, 32, 32, 3, device=sm90) for _ in range(4)]
    outs, snap, _ = serve.serve_stream(dep, [{m.INPUT: x} for x in xs])
    assert snap["requests"] == 4
    for x, out in zip(xs, outs):
        assert torch.equal(out[m.output], m.apply(params, x))


class _SleepStage:
    """A stand-in for a CNN ``GraphModel``: its one stage spins the card
    for ``cycles`` cycles, then returns 2 x + 1, noting the stream it ran
    on."""

    def __init__(self, cycles):
        self.cycles = cycles
        self.streams = set()

    def apply_subset(self, params, boundary, layers):
        self.streams.add(torch.cuda.current_stream().cuda_stream)
        torch.cuda._sleep(self.cycles)
        return {"y": boundary["x"] * 2 + 1}


def test_replica_workers_overlap_on_their_own_streams(sm90):
    """One stage replicated twice: both workers call the one function of
    ``cnn_stage_fns``, each on its own thread's stream, so two calls in
    flight overlap on the card (two take less than 1.5x one; on a shared
    stream each ``synchronize()`` would wait for the other's work) and
    each returns its own input's result."""
    from repro_torch.core.pipeline import PipelineExecutor

    class OneStage:
        stage_layers = [["y"]]

    model = _SleepStage(cycles=200_000_000)     # ~0.1 s at the card's clock
    fns = serve.cnn_stage_fns(model, {}, OneStage(), sm90)
    xs = [torch.full((4,), float(i), device=sm90) for i in range(3)]
    with PipelineExecutor(fns, replicas=[2]) as ex:
        ex.submit({"x": xs[2]}).result(60)       # warm-up
        t0 = time.perf_counter()
        ex.submit({"x": xs[2]}).result(60)
        one = time.perf_counter() - t0
        t0 = time.perf_counter()
        futs = [ex.submit({"x": x}) for x in xs[:2]]
        outs = [f.result(60) for f in futs]
        two = time.perf_counter() - t0
    assert len(model.streams) == 2
    for x, out in zip(xs, outs):
        assert torch.equal(out["y"], x * 2 + 1)
    assert two < 1.5 * one, (one, two)


# whisper-tiny's attention shapes (6/6 heads, D 64): the encoder's
# non-causal S = T = 1500 (not a multiple of the KV tile), the prefill's
# cross-attention of 448 tokens against 1500 frames, and a ragged S < T
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("s,t", [(1500, 1500), (448, 1500), (17, 1000)],
                         ids=["encoder", "cross", "ragged_cross"])
def test_whisper_shapes_flash_attention_matches_plain(sm90, s, t, dtype):
    g = torch.Generator(sm90).manual_seed(2)
    q, k, v = _attention_inputs(g, sm90, 2, 6, 6, s, t, 64, dtype,
                                layout=True)
    before = _build.launches("flash_attention")
    got = fa.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert _build.launches("flash_attention") == before + 1
    torch.testing.assert_close(
        got.float(), flash_attention_ref(q, k, v, causal=False).float(),
        rtol=TOL[dtype], atol=TOL[dtype])


# whisper's decode step over a layer's memory K/V (T 1500, every row) and
# over ragged lengths, MHA at D 64
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("lens", [[1500] * 16,
                                  [0, 1, 15, 16, 17, 500, 749, 750, 751,
                                   1000, 1234, 1488, 1499, 1500, 3, 64]],
                         ids=["full", "ragged"])
def test_whisper_shapes_flash_decode_matches_plain(sm90, lens, dtype):
    g = torch.Generator(sm90).manual_seed(3)
    q = torch.randn(16, 6, 64, generator=g, device=sm90,
                    dtype=DTYPES[dtype])
    k, v = (torch.randn(16, 1500, 6, 64, generator=g, device=sm90,
                        dtype=DTYPES[dtype]).transpose(1, 2)
            for _ in range(2))
    arg = torch.tensor(lens, dtype=torch.int32, device=sm90)
    got = fd.flash_decode(q, k, v, arg)
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(),
                               flash_decode_ref(q, k, v, arg).float(),
                               rtol=tol, atol=tol)
    if len(set(lens)) == 1:                     # the scalar length too
        torch.testing.assert_close(fd.flash_decode(q, k, v, 1500), got)


def test_whisper_smoke_on_card_matches_cpu(sm90):
    """whisper's smoke config (fp32) on the card against the CPU: the
    forward of 2 clips x 20 tokens, the encoder memory, and a greedy loop
    of 8 steps after a 4-token prompt from a cache built from that
    memory, within 1e-4, greedy tokens equal."""
    cfg = configs.get("whisper-tiny").smoke_config()
    cpu = torch.device("cpu")
    params = api.init(cfg, cpu, torch.Generator(cpu).manual_seed(0))
    card = _to(params, sm90)
    batch = concrete_batch(cfg, 20, 2, kind="prefill")
    torch.testing.assert_close(api.forward(cfg, card, batch).cpu(),
                               api.forward(cfg, params, batch),
                               rtol=1e-4, atol=1e-4)
    runs = []
    for dev, p in ((cpu, params), (sm90, card)):
        memory = whisper.encode(cfg, p, batch["frames"])
        cache = whisper.init_cache(cfg, 2, 16, dev, memory, p)
        seen, toks = [], []
        for i in range(12):
            tok = (batch["tokens"][:, i:i + 1] if i < 4 else toks[-1]).to(dev)
            logits, cache = api.decode(cfg, p, tok, cache)
            seen.append(logits.cpu())
            toks.append(logits[:, -1].argmax(-1, keepdim=True))
        runs.append((memory.cpu(), torch.cat(seen, 1),
                     torch.cat(toks, 1).cpu()))
    torch.testing.assert_close(runs[1][0], runs[0][0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(runs[1][1], runs[0][1], rtol=1e-4, atol=1e-4)
    assert torch.equal(runs[1][2], runs[0][2])


def test_cuda_reporter_measures_and_refines(sm90):
    """The segment reporter on the card: a range's bytes hold at least its
    blocks' weights and grow with the range; its refinement moves the
    balanced cuts of a budget they spill and converges."""
    import dataclasses
    from repro_torch.api import DeploymentSpec, plan
    from repro_torch.core.refine import refine_cuts
    from repro_torch.core.segmentation import segment_ranges
    from repro_torch.launch.cuda_reporter import CudaSegmentReporter
    from repro_torch.models import lm_graph
    cfg = dataclasses.replace(configs.get("qwen3-1.7b").smoke_config(),
                              n_layers=12, vocab=1024, dtype=torch.bfloat16)
    g = lm_graph.lm_layer_graph(cfg, seq_len=64)
    per = g.nodes["block_0"].weight_bytes
    rep = CudaSegmentReporter(cfg, g, 1 << 40, seq=64, device=sm90)
    used = [rep.segment_report(1, n)[0] for n in (1, 2, 4, 8)]
    assert rep.compilations == 4
    assert all(u >= n * per for u, n in zip(used, (1, 2, 4, 8)))
    assert used == sorted(used) and used[-1] > used[0] + 6 * per
    pl = plan(DeploymentSpec(stages=4, strategy="balanced_norefine"),
              graph=g)
    n = len(g.levels())
    sizes = [rep.segment_report(lo, hi)[0]
             for lo, hi in segment_ranges(n, pl.cuts)]
    budget = (max(sizes) + sum(sizes) // len(sizes)) // 2
    tight = CudaSegmentReporter(cfg, g, budget, seq=64, device=sm90)
    res = refine_cuts(pl.cuts, n, tight)
    assert res.converged and res.moves > 0 and res.cuts != pl.cuts
    assert all(tight.segment_report(lo, hi)[1] == 0
               for lo, hi in segment_ranges(n, res.cuts))


# ---------------------------------------------------------------------------
# the kernels' gradient refusal (C5)
# ---------------------------------------------------------------------------
def _grad_inputs(name, dev):
    g = torch.Generator(dev).manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev)
    if name == "flash_decode":
        return (r(2, 4, 64), r(2, 2, 128, 64), r(2, 2, 128, 64), 100)
    if name == "rwkv6_scan":
        w = torch.rand(1, 2, 8, 64, generator=g, device=dev)
        return (r(1, 2, 8, 64), r(1, 2, 8, 64), r(1, 2, 8, 64), w,
                r(2, 64), r(1, 2, 64, 64))
    return (torch.rand(2, 8, 64, generator=g, device=dev), r(2, 8, 64),
            r(2, 64))


@pytest.mark.parametrize("name", ["flash_decode"])
def test_kernels_refuse_a_gradient_on_card(sm90, name):
    """Asked for a gradient, a kernel with no backward raises instead of
    returning an output with no autograd edge; under no_grad it runs.
    (flash_attention, rwkv6_scan and rglru_scan have backwards: the tests
    below.)"""
    fn = {"flash_decode": fd.flash_decode, "rwkv6_scan": rw.rwkv6_scan,
          "rglru_scan": rg.rglru_scan}[name]
    args = _grad_inputs(name, sm90)
    _build.reset_launches()
    with torch.no_grad():
        fn(*args)
    assert _build.launches(name) == 1
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    for i in range(len(tensors)):
        marked = [t.clone().requires_grad_(j == i)
                  for j, t in enumerate(tensors)]
        with pytest.raises(RuntimeError, match="no backward"):
            fn(*marked, *args[len(tensors):])
    assert _build.launches(name) == 1


# ---------------------------------------------------------------------------
# the flash-attention backward
# ---------------------------------------------------------------------------
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BWD_L2_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _bwd_case(dev, b, hq, hkv, s, t, d, dtype, causal, window, layout=True):
    """q/k/v (model layout views), the forward's lse, and dO."""
    g = torch.Generator(dev).manual_seed(0)
    q, k, v = _attention_inputs(g, dev, b, hq, hkv, s, t, d, dtype, layout)
    _, lse = fa._forward(q, k, v, causal, window, with_lse=True)
    do = torch.randn(q.shape, generator=g, device=dev, dtype=DTYPES[dtype])
    return q, k, v, lse, do


def _assert_grads_close(got, expect, dtype):
    """Each gradient's largest deviation within ``BWD_TOL`` of its scale
    max(1, max |expect|), and its relative L2 error within
    ``BWD_L2_TOL``."""
    for a, e in zip(got, expect):
        assert a.dtype == e.dtype and a.shape == e.shape
        a, e = a.float(), e.float()
        scale = max(1.0, e.abs().max().item())
        err = (a - e).abs().max().item()
        assert err <= BWD_TOL[dtype] * scale, (err, scale)
        l2 = (torch.linalg.vector_norm(a - e)
              / torch.linalg.vector_norm(e)).item()
        assert l2 <= BWD_L2_TOL[dtype], l2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal,window", [
    (8, 16, 8, 1024, 1024, 128, True, None),    # qwen3-1.7b's training
    (2, 16, 8, 1024, 1024, 64, True, None),     # granite-moe's D 64
    (2, 32, 32, 1024, 1024, 96, True, None),    # phi3-mini's D 96
    (1, 16, 1, 4096, 4096, 256, True, 2048),    # recurrentgemma's window
    (8, 16, 1, 1024, 1024, 256, True, 2048),    # ... and its training
    (2, 6, 6, 1500, 1500, 64, False, None),     # whisper's encoder
    (2, 6, 6, 448, 1500, 64, False, None),      # whisper's cross
    (2, 4, 2, 1000, 1000, 128, True, None),     # ragged S = T
    (1, 4, 1, 72, 200, 16, True, None),         # ragged, S < T
    (1, 2, 2, 100, 37, 32, False, None),        # non-causal S > T
    (1, 4, 2, 500, 500, 64, True, 100),         # a window inside a tile
])
def test_flash_attention_bwd_matches_plain(sm90, b, hq, hkv, s, t, d,
                                           causal, window, dtype):
    q, k, v, lse, do = _bwd_case(sm90, b, hq, hkv, s, t, d, dtype, causal,
                                 window)
    _, lse_ref = flash_attention_ref(q, k, v, causal, window,
                                     return_lse=True)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5)
    _build.reset_launches()
    got = fa.flash_attention_bwd(q, k, v, lse, do, causal, window)
    torch.cuda.synchronize()
    assert _build.launches("flash_attention_bwd") == 1
    expect = flash_attention_bwd_ref(q, k, v, lse, do, causal, window)
    _assert_grads_close(got, expect, dtype)
    # the gradients keep their inputs' layouts
    for a, x in zip(got, (q, k, v)):
        assert a.stride() == x.stride()


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_is_deterministic(sm90, dtype, d):
    """Equal bits from call to call: bf16's dQ sums each key block's dS
    tile in key order, and no route uses atomics."""
    q, k, v, lse, do = _bwd_case(sm90, 2, 16, 2, 600, 600, d, dtype,
                                 True, None)
    first = fa.flash_attention_bwd(q, k, v, lse, do)
    second = fa.flash_attention_bwd(q, k, v, lse, do)
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.parametrize("d", [128, 256])
def test_flash_attention_bwd_splits_its_scratch_over_batch_rows(
        sm90, monkeypatch, d):
    """A scratch cap below one batch row's (bf16 dS tiles; at head dim 256
    also the dK/dV parts of two q-head shares): one row a launch, the same
    bits as one launch over the batch."""
    q, k, v, lse, do = _bwd_case(sm90, 3, 4, 2, 300, 300, d, "bfloat16",
                                 True, None)
    whole = fa.flash_attention_bwd(q, k, v, lse, do)
    monkeypatch.setattr(fa, "DS_SCRATCH_BYTES", 1)
    _build.reset_launches()
    rows = fa.flash_attention_bwd(q, k, v, lse, do)
    assert _build.launches("flash_attention_bwd") == 1
    for a, c in zip(whole, rows):
        assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 64])
def test_flash_attention_differentiates_on_card(sm90, dtype, window):
    """An input that requires grad: one forward launch (with lse) and one
    backward launch, the gradients those of the plain route."""
    g = torch.Generator(sm90).manual_seed(3)
    q, k, v = _attention_inputs(g, sm90, 2, 8, 2, 300, 300, 64, dtype, True)
    do = torch.randn(q.shape, generator=g, device=sm90, dtype=DTYPES[dtype])
    grads = []
    for fn in (fa.flash_attention, flash_attention_ref):
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        _build.reset_launches()
        out = fn(*leaves, True, window)
        out.backward(do)
        torch.cuda.synchronize()
        launched = (_build.launches("flash_attention"),
                    _build.launches("flash_attention_bwd"))
        assert launched == ((1, 1) if fn is fa.flash_attention else (0, 0))
        grads.append([x.grad for x in leaves])
    _assert_grads_close(grads[0], grads[1], dtype)


# ---------------------------------------------------------------------------
# the scans' backwards
# ---------------------------------------------------------------------------
def _assert_scan_grads(got, expect, dtype):
    """Each gradient finite, its largest deviation within BWD_TOL of its
    scale max(1, max |plain|) and its relative L2 error within
    BWD_L2_TOL."""
    for a, e in zip(got, expect):
        assert a.shape == e.shape and a.dtype == e.dtype
        a, e = a.float(), e.float()
        assert bool(torch.isfinite(a).all())
        scale = max(1.0, e.abs().max().item())
        assert (a - e).abs().max().item() <= BWD_TOL[dtype] * scale
        norm = torch.linalg.vector_norm(e).item()
        l2 = torch.linalg.vector_norm(a - e).item() / (norm or 1.0)
        assert l2 <= BWD_L2_TOL[dtype], l2


def _rwkv6_bwd_case(dev, b, h, s, d, dtype, layout, extreme=False):
    g = torch.Generator(dev).manual_seed(5)

    def x(scale=1.0, uniform=False):
        shape = (b, s, h, d) if layout else (b, h, s, d)
        t = (0.7 + 0.3 * torch.rand(shape, generator=g, device=dev)
             if uniform else
             scale * torch.randn(shape, generator=g, device=dev))
        t = t.to(DTYPES[dtype])
        return t.transpose(1, 2) if layout else t

    r, k, v, w = x(), x(0.2), x(), x(uniform=True)
    if extreme:           # alternate steps at the two ends of [0, 1]
        w[:, :, 0::2] = 1e-30
        w[:, :, 1::2] = 1.0
    u = 0.2 * torch.randn(h, d, generator=g, device=dev)
    s0 = 0.1 * torch.randn(b, h, d, d, generator=g, device=dev)
    dy = x()
    ds_last = torch.randn(b, h, d, d, generator=g, device=dev)
    return (r, k, v, w, u, s0), dy, ds_last


@pytest.mark.parametrize("b,h,s,d,dtype,layout,extreme", [
    (8, 32, 1024, 64, "float32", True, False),   # rwkv6-1.6b's training
    (2, 32, 300, 64, "float32", True, False),    # ragged S
    (2, 4, 257, 32, "float32", False, False),
    (2, 4, 100, 16, "float32", True, False),
    (4, 32, 1, 64, "float32", True, False),      # S = 1
    (2, 32, 31, 64, "float32", True, True),      # decays 1e-30 and 1
    (2, 4, 37, 16, "float32", True, True),       # ... one block a (b, h)
    (2, 4, 45, 32, "bfloat16", False, True),     # ... a cluster of two
    (2, 32, 300, 64, "bfloat16", True, False),
    (2, 4, 70, 16, "bfloat16", False, False),
])
def test_rwkv6_scan_bwd_matches_plain(sm90, b, h, s, d, dtype, layout,
                                      extreme):
    xs, dy, ds_last = _rwkv6_bwd_case(sm90, b, h, s, d, dtype, layout,
                                      extreme)
    _build.reset_launches()
    got = rw.rwkv6_scan_bwd(*xs, dy, ds_last)
    again = rw.rwkv6_scan_bwd(*xs, dy, ds_last)
    torch.cuda.synchronize()
    assert _build.launches("rwkv6_scan_bwd") == 2
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    # the gradients keep their inputs' layouts
    for a, x in zip(got[:4], xs[:4]):
        assert a.stride() == x.stride()
    _assert_scan_grads(got, rwkv6_scan_bwd_ref(*xs, dy, ds_last), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,d", [(1, 64), (8, 16), (9, 32), (70, 64)])
def test_rwkv6_scan_checkpoints_equal_prefix_s_last(sm90, s, d, dtype):
    """The forward's checkpoint epilogue: piece p's state equal bit for
    bit to the s_last of the same kernel run on the first 8p steps (s0
    for p = 0), and y equal to the launch's without it."""
    (r, k, v, w, u, s0), _, _ = _rwkv6_bwd_case(sm90, 2, 4, s, d, dtype,
                                                True)
    y, _, states = rw._forward(r, k, v, w, u, s0, None, with_states=True)
    y_serve = rw._forward(r, k, v, w, u, s0, None)[0]
    assert torch.equal(y, y_serve)
    assert states.shape == (2, 4, -(-s // 8), d, d)
    assert torch.equal(states[:, :, 0], s0)
    for p in range(1, states.shape[2]):
        s_last = rw._forward(*(x[:, :, :8 * p] for x in (r, k, v, w)),
                             u, s0, None)[1]
        assert torch.equal(states[:, :, p], s_last), p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_scan_bwd_from_saved_states_equals_the_call_without(sm90,
                                                                  dtype):
    """Given the forward's states, one rwkv6_scan_bwd launch and no forward;
    without them a forward launch with the epilogue first: the same
    bits."""
    xs, dy, ds_last = _rwkv6_bwd_case(sm90, 2, 32, 300, 64, dtype, True)
    _, _, states = rw._forward(*xs, None, with_states=True)
    _build.reset_launches()
    given = rw.rwkv6_scan_bwd(*xs, dy, ds_last, states)
    torch.cuda.synchronize()
    assert (_build.launches("rwkv6_scan"),
            _build.launches("rwkv6_scan_bwd")) == (0, 1)
    alone = rw.rwkv6_scan_bwd(*xs, dy, ds_last)
    torch.cuda.synchronize()
    assert (_build.launches("rwkv6_scan"),
            _build.launches("rwkv6_scan_bwd")) == (1, 2)
    assert all(torch.equal(a, c) for a, c in zip(given, alone))


def test_rwkv6_scan_under_no_saved_states_on_card(sm90):
    """A remat's first forward: the kernel without its epilogue, a
    zero-stride stand-in saved; the backward (here on that stand-in) runs
    a forward with the epilogue first, and the gradients are those of the
    recording forward."""
    xs, dy, ds_last = _rwkv6_bwd_case(sm90, 2, 4, 70, 64, "float32", True)
    grads = []
    for skip in (True, False):
        leaves = [x.detach().clone().requires_grad_() for x in xs]
        _build.reset_launches()
        with rw.no_saved_states() if skip else torch.enable_grad():
            y, s_last = rw.rwkv6_scan(*leaves)
        saved = y.grad_fn.saved_tensors[-1]
        assert (set(saved.stride()) == {0}) == skip
        torch.autograd.backward((y, s_last), (dy, ds_last))
        torch.cuda.synchronize()
        assert (_build.launches("rwkv6_scan"),
                _build.launches("rwkv6_scan_bwd")) == (1 + skip, 1)
        grads.append([x.grad for x in leaves])
    for a, c in zip(*grads):
        assert torch.equal(a, c)


def test_rwkv6_scan_bwd_takes_absent_cotangents(sm90):
    xs, dy, ds_last = _rwkv6_bwd_case(sm90, 2, 4, 40, 64, "float32", True)
    for args in ((dy, None), (None, ds_last)):
        _assert_scan_grads(rw.rwkv6_scan_bwd(*xs, *args),
                           rwkv6_scan_bwd_ref(*xs, *args), "float32")


@pytest.mark.parametrize("b,s,r,dtype,extreme", [
    (8, 1024, 4096, "float32", False),        # recurrentgemma's training
    (2, 40, 4096, "float32", False),          # a short S
    (2, 1, 4096, "float32", False),           # S = 1
    (3, 300, 1000, "float32", True),          # ragged R, decays 1e-30 / 1
    (8, 1024, 4096, "bfloat16", False),
    (2, 77, 1001, "bfloat16", True),
])
def test_rglru_scan_bwd_matches_plain(sm90, b, s, r, dtype, extreme):
    """Given the forward epilogue's checkpoints, one rglru_scan_bwd launch
    and no forward; without them a forward launch with the epilogue
    first: the same bits, and the plain version's gradients."""
    a, x, h0 = (t.to(sm90) for t in _rglru_bwd_inputs(b, s, r, dtype,
                                                      extreme))
    g = torch.Generator(sm90).manual_seed(9)
    _, _, ckpt = rg._forward(a, x, h0, with_checkpoints=True)
    dy = torch.randn(b, s, r, generator=g, device=sm90).to(DTYPES[dtype])
    dh_last = torch.randn(b, r, generator=g, device=sm90)
    _build.reset_launches()
    got = rg.rglru_scan_bwd(a, x, h0, dy, dh_last, ckpt)
    torch.cuda.synchronize()
    assert (_build.launches("rglru_scan"),
            _build.launches("rglru_scan_bwd")) == (0, 1)
    alone = rg.rglru_scan_bwd(a, x, h0, dy, dh_last)
    torch.cuda.synchronize()
    assert (_build.launches("rglru_scan"),
            _build.launches("rglru_scan_bwd")) == (1, 2)
    assert all(torch.equal(u, v) for u, v in zip(got, alone))
    _assert_scan_grads(got, rglru_scan_bwd_ref(a, x, h0, dy, dh_last),
                       dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,r", [(2, 1, 4096), (2, 40, 4096),
                                   (2, 300, 4096), (3, 300, 1000),
                                   (2, 77, 1001)])
def test_rglru_scan_checkpoints_equal_the_fp32_forward_carries(sm90, b, s,
                                                               r, dtype):
    """The forward's checkpoint epilogue (staged and step routes):
    checkpoint 0 is h0 and checkpoint p the fp32 forward kernel's
    y[:, 64p - 1] on the widened inputs, bit for bit, and y equal to the
    launch's without the epilogue."""
    a, x, h0 = (t.to(sm90) for t in _rglru_bwd_inputs(b, s, r, dtype,
                                                      True))
    y, h_last, ckpt = rg._forward(a, x, h0, with_checkpoints=True)
    y_serve, h_serve, none = rg._forward(a, x, h0)
    y32, _ = rg.rglru_scan(a.float(), x.float(), h0)
    torch.cuda.synchronize()
    assert none is None
    assert torch.equal(y, y_serve) and torch.equal(h_last, h_serve)
    assert ckpt.shape == (b, -(-s // 64), r) and ckpt.dtype == torch.float32
    assert torch.equal(ckpt[:, 0], h0)
    for p in range(1, ckpt.shape[1]):
        assert torch.equal(ckpt[:, p], y32[:, 64 * p - 1]), p


@pytest.mark.parametrize("b,s,r,dtype", [(8, 1024, 4096, "float32"),
                                         (2, 77, 4096, "bfloat16"),
                                         (3, 300, 1000, "bfloat16")])
def test_rglru_scan_bwd_staged_route_equals_step_route(sm90, b, s, r, dtype):
    """The backward's two routes run the same FMAs, adds and multiplies in
    the same order: equal bits."""
    plan = rg.bwd_plan(r, DTYPES[dtype].itemsize)
    assert plan == rg.BWD_STAGED
    a, x, h0 = (t.to(sm90) for t in _rglru_bwd_inputs(b, s, r, dtype,
                                                      True))
    g = torch.Generator(sm90).manual_seed(10)
    ckpt = rg._forward(a, x, h0, with_checkpoints=True)[2]
    dy = torch.randn(b, s, r, generator=g, device=sm90).to(DTYPES[dtype])
    dh_last = torch.randn(b, r, generator=g, device=sm90)
    staged = rg.bwd_launch(a, x, ckpt, dy, dh_last, plan)
    step = rg.bwd_launch(a, x, ckpt, dy, dh_last, rg.STEP)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(staged, step))


def _rglru_bwd_inputs(b, s, r, dtype, extreme):
    g = torch.Generator().manual_seed(8)
    a = 0.3 + 0.7 * torch.rand(b, s, r, generator=g)
    if extreme:
        a[:, 0::2] = 1e-30
        a[:, 1::2, 0::2] = 1.0
    x = 0.2 * torch.randn(b, s, r, generator=g)
    return a.to(DTYPES[dtype]), x.to(DTYPES[dtype]), torch.randn(
        b, r, generator=g)


@pytest.mark.parametrize("name", ["rwkv6_scan", "rglru_scan"])
def test_scan_differentiates_on_card(sm90, name):
    """Inputs that require grad: one forward launch and one backward
    launch, every input's gradient that of autograd through the plain
    version on the same card."""
    fn, plain = {"rwkv6_scan": (rw.rwkv6_scan, rwkv6_scan_ref),
                 "rglru_scan": (rg.rglru_scan, rglru_scan_ref)}[name]
    args = _grad_inputs(name, sm90)
    g = torch.Generator(sm90).manual_seed(4)
    grads = []
    for f in (fn, plain):
        leaves = [x.detach().clone().requires_grad_() for x in args]
        _build.reset_launches()
        y, last = f(*leaves)
        torch.autograd.backward(
            (y, last), (torch.randn(y.shape, generator=g, device=sm90),
                        torch.randn(last.shape, generator=g, device=sm90)))
        torch.cuda.synchronize()
        launched = (_build.launches(name), _build.launches(name + "_bwd"))
        assert launched == ((1, 1) if f is fn else (0, 0))
        grads.append([x.grad for x in leaves])
        g.manual_seed(4)
    _assert_scan_grads(grads[0], grads[1], "float32")


TRAIN_COUNTS = {  # per smoke config: kernel -> launches of one train step
    "rwkv6-1.6b": lambda cfg: {"rwkv6_scan": cfg.n_layers,
                               "rwkv6_scan_bwd": cfg.n_layers},
    "recurrentgemma-9b": lambda cfg: {
        "rglru_scan": cfg.n_layers - cfg.n_layers // cfg.attn_every,
        "rglru_scan_bwd": cfg.n_layers - cfg.n_layers // cfg.attn_every,
        "flash_attention": cfg.n_layers // cfg.attn_every,
        "flash_attention_bwd": cfg.n_layers // cfg.attn_every},
}


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m",
                                  "whisper-tiny", "rwkv6-1.6b",
                                  "recurrentgemma-9b"])
def test_smoke_train_step_on_card_matches_cpu(sm90, arch):
    """The smoke config (fp32, TF32 off) from the same weights, state and
    batch: each gradient leaf within 1e-4 relative L2 of the CPU's, every
    attention call once through each flash kernel; then one train step:
    loss, grad_norm and lr within 1e-4, every updated parameter within
    1e-4 of max(1, max |CPU|).  (AdamW divides each gradient element by its
    own running magnitude, so an element whose gradient sits near eps
    moves by an amount that rounding decides: the updated parameters are
    compared at their scale, the gradients leaf by leaf.)"""
    from repro_torch.launch import steps
    from repro_torch.optim import AdamWConfig
    from repro_torch.checkpoint.store import tree_flatten
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get(arch).smoke_config()
    cpu = torch.device("cpu")
    params, state = steps.init_train_state(
        cfg, cpu, torch.Generator(cpu).manual_seed(0))
    batch = concrete_batch(cfg, 64, 2, rng=np.random.default_rng(1))
    to = lambda tree: tree_map(lambda x: x.to(sm90), tree)  # noqa: E731
    card_batch = {k: x.to(sm90) for k, x in batch.items()}
    _build.reset_launches()
    loss, grads = steps.loss_and_grads(cfg, to(params), card_batch, 32)
    torch.cuda.synchronize()
    # every attention call once forward (the smoke configs keep no remat)
    # and once backward: whisper's encoder self-attention and its
    # decoder's self- and cross-attention
    n_attn = (cfg.n_enc_layers + 2 * cfg.n_layers
              if cfg.family == "encdec" else cfg.n_layers)
    expect = TRAIN_COUNTS.get(arch, lambda cfg: {
        "flash_attention": n_attn, "flash_attention_bwd": n_attn})(cfg)
    for name in ("flash_attention", "flash_attention_bwd", "flash_decode",
                 "rwkv6_scan", "rwkv6_scan_bwd", "rglru_scan",
                 "rglru_scan_bwd"):
        assert _build.launches(name) == expect.get(name, 0), name
    loss_cpu, grads_cpu = steps.loss_and_grads(cfg, params, batch, 32)
    torch.testing.assert_close(loss.cpu(), loss_cpu, rtol=1e-5, atol=0)
    for a, e in zip(tree_flatten(grads)[0], tree_flatten(grads_cpu)[0]):
        err = torch.linalg.vector_norm(a.cpu() - e)
        assert err <= 1e-4 * torch.linalg.vector_norm(e)

    step = steps.make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                                  total_steps=4), 32)
    got = step(to(params), to(state), card_batch)
    expect = step(params, state, batch)
    for key in ("loss", "grad_norm", "lr"):
        torch.testing.assert_close(got[2][key].cpu(), expect[2][key],
                                   rtol=1e-4, atol=1e-6)
    for a, e in zip(tree_flatten(got[0])[0], tree_flatten(expect[0])[0]):
        scale = max(1.0, e.abs().max().item())
        assert (a.cpu() - e).abs().max().item() <= 1e-4 * scale


# ---------------------------------------------------------------------------
# the SPMD tier's stream schedule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m", [4, 9], ids=["m=S", "m=2S+1"])
@pytest.mark.parametrize("slow", [(4, 0, 0, 0), (0, 0, 0, 4), (0, 4, 0, 4)],
                         ids=["slow_first", "slow_last", "slow_alternate"])
@pytest.mark.parametrize("pressure", [False, True],
                         ids=["cached", "empty_cache"])
def test_stream_schedule_equals_one_stream(sm90, m, slow, pressure):
    """The schedule over 4 stage streams equals the same stage functions
    composed microbatch by microbatch on one stream.  Stages that sleep
    on the card make a missing event wait read a hop before it is
    written, and a missing ``record_stream`` hand a hop's memory to the
    next microbatch while its reader still waits; ``empty_cache`` between
    microbatches releases the allocator's cached blocks."""
    from repro_torch.launch import pipeline_spmd as spmd
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(sm90).manual_seed(0)
    ws = [torch.randn(256, 256, generator=g, device=sm90) / 16
          for _ in range(4)]

    def stage(s):
        def fn(x):
            if pressure:
                torch.cuda.empty_cache()
            if slow[s]:
                torch.cuda._sleep(slow[s] * 1_000_000)
            return torch.tanh(x @ ws[s]) + x
        return fn

    fns = [stage(s) for s in range(4)]
    x_all = torch.randn(m, 32, 256, generator=g, device=sm90)
    mesh = spmd.default_stage_mesh(4)
    got = spmd._gpipe_outputs(fns, mesh.streams, x_all)
    expect = []
    for i in range(m):
        y = x_all[i]
        for fn in fns:
            y = fn(y)
        expect.append(y)
    torch.testing.assert_close(got, torch.stack(expect), rtol=1e-5,
                               atol=1e-5)


def test_spmd_lm_executor_on_card_matches_cpu(sm90):
    """qwen3's smoke config through the SPMD executor, 4 stages and 9
    microbatches of one row: the card (stage streams, flash_attention's
    fp32 route, 4 launches a microbatch) against the CPU (the plain
    version), within 1e-4."""
    from repro_torch.launch import pipeline_spmd as spmd
    from repro_torch.models import lm_graph
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get("qwen3-1.7b").smoke_config()
    cpu = torch.device("cpu")
    params = api.init(cfg, cpu, torch.Generator(cpu).manual_seed(0))
    pl = tapi.plan(tapi.DeploymentSpec(stages=4,
                                       strategy="balanced_norefine"),
                   graph=lm_graph.lm_layer_graph(cfg, seq_len=64))
    tokens = concrete_batch(cfg, 64, 9, kind="prefill")["tokens"]
    outs = []
    for dev in (cpu, sm90):
        with spmd.SpmdPipelineExecutor.for_lm(
                cfg, params, pl, mesh=spmd.default_stage_mesh(4, dev),
                n_microbatches=9, batch_size=9, seq_len=64) as ex:
            _build.reset_launches()
            outs.append(ex(tokens).cpu())
            assert _build.launches("flash_attention") == (
                0 if dev == cpu else cfg.n_layers * 9)
            assert all(t > 0 for t in ex.achieved_stage_times(2, 1))
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-4, atol=1e-4)


def test_spmd_compose_right_after_build_waits_for_the_stage_weights(sm90):
    """``compose`` called first, with no call and no sync after the
    executor is built: it runs on the cards' current streams, while the
    blocks' fp32 copies of the bf16 weights are made on the stage streams,
    here held back by a sleep of at least 2 s queued on each before the
    build.  The host path is warmed first by an executor of other
    weights, and the build must return well inside the sleep, so that
    ``compose`` is issued while the copies are still queued.  It equals
    the CPU executor's output within 1e-4, on one card and, where two or
    more are visible, over them."""
    import dataclasses
    from repro_torch.launch import pipeline_spmd as spmd
    from repro_torch.models import lm_graph
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get("qwen3-1.7b").smoke_config(),
                              dtype=torch.bfloat16)
    cpu = torch.device("cpu")
    params, other = (api.init(cfg, cpu, torch.Generator(cpu).manual_seed(s))
                     for s in (5, 6))
    pl = tapi.plan(tapi.DeploymentSpec(stages=4,
                                       strategy="balanced_norefine"),
                   graph=lm_graph.lm_layer_graph(cfg, seq_len=64))
    tokens = concrete_batch(cfg, 64, 4, kind="prefill")["tokens"]

    def executor(mesh, p):
        return spmd.SpmdPipelineExecutor.for_lm(cfg, p, pl, mesh=mesh,
                                                n_microbatches=4)

    with executor(spmd.default_stage_mesh(4, cpu), params) as ex:
        want = ex(tokens)
    n = min(torch.cuda.device_count(), 4)
    for k in sorted({1, n if n >= 2 else 1}):
        mesh = spmd.default_stage_mesh(4, "cuda", cards=k)
        with executor(mesh, other) as ex:
            ex.compose(tokens).cpu()
        for dev in mesh.cards:
            torch.cuda.synchronize(dev)
        for st in mesh.streams:
            with torch.cuda.stream(st):
                torch.cuda._sleep(4_000_000_000)   # >= 2 s at 1.98 GHz
        t0 = time.perf_counter()
        with executor(mesh, params) as ex:
            built_s = time.perf_counter() - t0
            got = ex.compose(tokens)
            assert got.device == mesh.devices[-1]
            torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                                       atol=1e-4)
        assert built_s < 1.0, built_s


# ---------------------------------------------------------------------------
# several cards: per-device launch setup and the SPMD tier over cards
# ---------------------------------------------------------------------------
@pytest.fixture
def cards(sm90):
    """Every visible card, up to four; skips with fewer than two."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    return [torch.device("cuda", c) for c in range(min(n, 4))]


def _card_kernel_cases(dev):
    """(name, run, plain, tol) of each launcher that sets up its dynamic
    shared memory per device, at a shape above 48 KB of it (flash_decode
    bf16 D 128: 108 KB; rwkv6_scan's 64-step chunks; the rglru scans'
    staged routes), on ``dev``; the backwards from the forward epilogue's
    states / checkpoints."""
    g = torch.Generator(dev).manual_seed(0)
    q = torch.randn(2, 16, 128, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(2, 8, 512, 128, generator=g, device=dev).bfloat16()
            for _ in range(2))
    rx, rdy, rds = _rwkv6_bwd_case(dev, 1, 2, 128, 64, "float32", False)
    a, gx, h0 = (t.to(dev) for t in _rglru_bwd_inputs(1, 128, 256,
                                                      "float32", False))
    gdy = torch.randn(1, 128, 256, generator=g, device=dev)
    gdh = torch.randn(1, 256, generator=g, device=dev)

    def rwkv6_bwd():
        states = rw._forward(*rx, None, with_states=True)[2]
        return rw.rwkv6_scan_bwd(*rx, rdy, rds, states)

    def rglru_bwd():
        ckpt = rg._forward(a, gx, h0, with_checkpoints=True)[2]
        return rg.rglru_scan_bwd(a, gx, h0, gdy, gdh, ckpt)

    return (
        ("flash_decode", lambda: fd.flash_decode(q, k, v, 512),
         lambda: flash_decode_ref(q, k, v, 512), 2e-2),
        ("rwkv6_scan", lambda: rw.rwkv6_scan(*rx),
         lambda: rwkv6_scan_ref(*rx), 2e-4),
        ("rwkv6_scan_bwd", rwkv6_bwd,
         lambda: rwkv6_scan_bwd_ref(*rx, rdy, rds), None),
        ("rglru_scan", lambda: rg.rglru_scan(a, gx, h0),
         lambda: rglru_scan_ref(a, gx, h0), 1e-5),
        ("rglru_scan_bwd", rglru_bwd,
         lambda: rglru_scan_bwd_ref(a, gx, h0, gdy, gdh), None))


def test_launchers_set_up_shared_memory_on_every_card(cards):
    """Each launcher that raises its dynamic shared-memory limit does so on
    every card it launches on: a setup kept per process fails the first
    launch on the second card.  Each card in turn, against the plain
    version there; the launches counted by card."""
    _build.reset_launches()
    for dev in cards:
        for name, run, plain, tol in _card_kernel_cases(dev):
            got, want = run(), plain()
            torch.cuda.synchronize(dev)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            assert all(t.device == dev for t in got), name
            if tol is None:
                _assert_scan_grads(got, want, "float32")
            else:
                for x, y in zip(got, want):
                    torch.testing.assert_close(x.float(), y.float(),
                                               rtol=tol, atol=tol)
    every = {dev.index: 1 for dev in cards}
    for name in ("flash_decode", "rwkv6_scan_bwd", "rglru_scan_bwd"):
        assert _build.launches_by_card(name) == every, name
    for name in ("rwkv6_scan", "rglru_scan"):     # and the backwards' own
        assert _build.launches_by_card(name) == {
            dev.index: 2 for dev in cards}, name


def test_spmd_executors_over_cards_match_one_card(cards):
    """qwen3's smoke config and a synthetic CNN over the cards, a stage
    each (4 stages over 2 cards: two each), against the same executors on
    one card's streams, within 1e-4; outputs on the last stage's card;
    flash_attention launched on every card as its blocks say."""
    from repro_torch.launch import pipeline_spmd as spmd
    from repro_torch.models import lm_graph
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = len(cards)
    cpu = torch.device("cpu")
    cfg = configs.get("qwen3-1.7b").smoke_config()
    params = api.init(cfg, cpu, torch.Generator(cpu).manual_seed(0))
    pl = tapi.plan(tapi.DeploymentSpec(stages=4,
                                       strategy="balanced_norefine"),
                   graph=lm_graph.lm_layer_graph(cfg, seq_len=64))
    counts = serve.stage_block_counts(pl, cfg.n_layers)
    tokens = concrete_batch(cfg, 64, 8, kind="prefill")["tokens"]
    m = cnn.synthetic_cnn(8, L=6, hw=32)
    cpl = tapi.plan(tapi.DeploymentSpec(stages=4,
                                        strategy="balanced_norefine"),
                    graph=m.to_layer_graph())
    cparams = m.init(cpu, torch.Generator(cpu).manual_seed(0))
    x = torch.randn((8,) + m.input_shape,
                    generator=torch.Generator().manual_seed(1))
    outs = {}
    for k in (1, n):
        mesh = spmd.default_stage_mesh(4, "cuda", cards=k)
        assert [d.index for d in mesh.devices] == spmd.stage_cards(4, k)
        with spmd.SpmdPipelineExecutor.for_lm(
                cfg, params, pl, mesh=mesh, n_microbatches=4,
                batch_size=8, seq_len=64) as ex:
            _build.reset_launches()
            got = ex(tokens)
            for dev in mesh.cards:
                torch.cuda.synchronize(dev)
            want = {}
            for dev, c in zip(mesh.devices, counts):
                want[dev.index] = want.get(dev.index, 0) + 4 * c
            assert _build.launches_by_card("flash_attention") == want
            assert got.device == mesh.devices[-1]
            outs["lm", k] = got.cpu()
            outs["lm composed", k] = ex.compose(tokens).cpu()
            assert all(t > 0 for t in ex.achieved_stage_times(2, 1))
        with spmd.SpmdPipelineExecutor.for_cnn(
                m, cparams, cpl, mesh=mesh, n_microbatches=4,
                batch_size=8) as ex:
            got = ex(x)
            assert got.device == mesh.devices[-1]
            outs["cnn", k] = got.cpu()
    for kind in ("lm", "lm composed", "cnn"):
        torch.testing.assert_close(outs[kind, n], outs[kind, 1], rtol=1e-4,
                                   atol=1e-4)
    torch.testing.assert_close(outs["lm", n], outs["lm composed", n],
                               rtol=1e-4, atol=1e-4)
