"""The port's CUDA kernels and CUDA paths against their plain versions.

Marked ``cuda``: they need a card of compute capability 9.0 or newer and
skip elsewhere.  This file imports no JAX, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 1e-4 in fp32 (summation order of the kernel's online softmax
against the materialized one; flash_decode, whose sums are shorter, 1e-5),
2e-2 in bf16 (one bf16 rounding of outputs of magnitude ~1).  The scans:
rtol = atol = 2e-4 (rwkv6_scan) and 1e-5 (rglru_scan) in fp32, 2e-2 in
bf16, the tolerances of the reference's own kernel tests.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs
from repro_torch.configs.common import concrete_batch
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rwkv6_scan as rw
from repro_torch.kernels.ref import (flash_attention_ref, flash_decode_ref,
                                     rglru_scan_ref, rwkv6_scan_ref)
from repro_torch.launch import serve
from repro_torch.models import api, lm

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


@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal,dtype", [
    (1, 2, 2, 128, 128, 64, True, "float32"),
    (2, 4, 2, 256, 256, 64, True, "float32"),
    (1, 8, 1, 128, 256, 128, True, "float32"),      # MQA, s != t
    (2, 2, 2, 128, 128, 64, False, "float32"),
    (1, 4, 4, 256, 256, 64, True, "bfloat16"),
    (2, 4, 1, 72, 200, 16, True, "float32"),        # ragged
    (1, 2, 2, 24, 16, 32, False, "float32"),        # non-causal, s > t
    (1, 16, 8, 1000, 1000, 128, True, "bfloat16"),  # the slice's widths
    (1, 16, 8, 128, 1024, 128, True, "bfloat16"),
    (2, 16, 1, 256, 256, 256, True, "bfloat16"),    # recurrentgemma MQA
    (1, 16, 1, 200, 200, 256, True, "float32"),
])
def test_kernel_matches_plain(sm90, b, hq, hkv, s, t, d, causal, dtype):
    g = torch.Generator(sm90).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=sm90,
                           dtype=DTYPES[dtype])
               for shape in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d)))
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


@pytest.mark.parametrize("b,s,r,dtype", [
    (2, 512, 4096, "float32"),                      # recurrentgemma widths
    (2, 1, 4096, "float32"),                        # the decode step
    (3, 100, 1000, "bfloat16"),                     # ragged channels
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
