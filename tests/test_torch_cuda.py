"""The port's CUDA kernel and CUDA paths against their plain versions.

Marked ``cuda``: they need a card of compute capability 9.0 or newer and
skip elsewhere.  This file imports no JAX, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 1e-4 in fp32 (summation order of the kernel's online softmax
against the materialized one), 2e-2 in bf16 (one bf16 rounding of outputs
of magnitude ~1).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs
from repro_torch.configs.common import concrete_batch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import flash_attention_ref
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
