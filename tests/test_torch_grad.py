"""The kernels' gradients on the CPU route, and the refusal of a
gradient a kernel cannot give.

``flash_attention``, ``rwkv6_scan`` and ``rglru_scan`` have backward
kernels (``csrc/<name>_bwd.cu``; held against their plain versions on the
card in ``tests/test_torch_cuda.py`` and against ``jax.vjp`` in
``tests/test_torch_flash_attention_bwd.py`` and
``tests/test_torch_scan_bwd.py``).  Only ``flash_decode``'s CUDA kernel has
none, so on the card its wrapper raises when autograd records and an input
requires grad (``kernels._build.refuse_grad``; pinned on the card in
``tests/test_torch_cuda.py``).  On the CPU every wrapper differentiates
(the three through their autograd functions' plain backwards,
``flash_decode`` through its plain version): every input gets a finite
gradient.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.rwkv6_scan import rwkv6_scan


def test_refuse_grad_only_when_autograd_records():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.refuse_grad("flash_decode", None, x.detach(), x)
    with torch.no_grad():
        _build.refuse_grad("flash_decode", x)
    with torch.inference_mode():
        _build.refuse_grad("flash_decode", x)
    _build.refuse_grad("flash_decode", x.detach(), None)


def _inputs(name, g):
    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).requires_grad_()
    if name == "flash_attention":
        return (r(1, 4, 8, 16), r(1, 2, 8, 16), r(1, 2, 8, 16))
    if name == "flash_decode":
        return (r(2, 4, 16), r(2, 2, 8, 16), r(2, 2, 8, 16), 5)
    if name == "rwkv6_scan":
        w = torch.rand(1, 2, 6, 16, generator=g).requires_grad_()
        return (r(1, 2, 6, 16), r(1, 2, 6, 16), r(1, 2, 6, 16), w,
                r(2, 16), r(1, 2, 16, 16))
    a = torch.rand(2, 6, 8, generator=g).requires_grad_()
    return (a, r(2, 6, 8), r(2, 8))


FNS = {"flash_attention": flash_attention, "flash_decode": flash_decode,
       "rwkv6_scan": rwkv6_scan, "rglru_scan": rglru_scan}


@pytest.mark.parametrize("name", list(FNS))
def test_cpu_route_still_differentiates(name):
    args = _inputs(name, torch.Generator().manual_seed(0))
    out = FNS[name](*args)
    outs = out if isinstance(out, tuple) else (out,)
    sum(o.float().sum() for o in outs).backward()
    for t in args:
        if isinstance(t, torch.Tensor):
            assert t.grad is not None and bool(torch.isfinite(t.grad).all())
