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
(fp32, TF32 off; convolution algorithms sum in other orders).
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
from repro_torch.kernels.ref import (flash_attention_ref, flash_decode_ref,
                                     matmul_qi8_ref, rglru_scan_ref,
                                     rwkv6_scan_ref)
from repro_torch.launch import serve
from repro_torch.models import api, cnn, lm

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
