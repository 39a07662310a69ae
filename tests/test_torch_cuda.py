"""The port's CUDA kernels and CUDA paths against their plain versions.

Marked ``cuda``: they need a card of compute capability 9.0 or newer and
skip elsewhere.  This file imports no JAX, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 1e-4 in fp32 (summation order of the kernel's online softmax
against the materialized one; flash_decode, whose sums are shorter, 1e-5),
2e-2 in bf16 (one bf16 rounding of outputs of magnitude ~1).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs
from repro_torch.configs.common import concrete_batch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels.ref import flash_attention_ref, flash_decode_ref
from repro_torch.launch import serve
from repro_torch.models import lm

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
])
def test_kernel_matches_plain(sm90, b, hq, hkv, s, t, d, causal, dtype):
    g = torch.Generator(sm90).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=sm90,
                           dtype=DTYPES[dtype])
               for shape in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d)))
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
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
    fa.reset_launches()
    res = serve.run(serve.parse_args(["--smoke", "--stages", "3",
                                      "--requests", "4", "--seq", "100"]))
    assert fa.launches == res["cfg"].n_layers * (4 + 2)
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
    before = fd.launches
    got = fd.flash_decode(q, k, v, arg)
    torch.cuda.synchronize()
    assert fd.launches == before + 1
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
