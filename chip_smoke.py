#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel of the serving path from the sources in this
   checkout (one nvcc per source, started together);
3. holds each kernel against its plain PyTorch version at the shapes the
   serving path gives it, and times kernel, plain version and one library
   call (the yardstick; the port never calls it);
4. holds the full model on the card against the same model on the CPU at
   the smoke config (the CPU runs the plain attention);
5. drives the serving path -- the balanced 4-stage plan of full-width
   qwen3-1.7b with random weights from a seed, 8 streamed requests of 1024
   tokens -- with every kernel's launch count set to 0 just before and read
   just after, checks the output against the direct forward, and checks
   that every layer of every forward went through the kernel;
6. prints one JSON line of kernel results, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Any failed phase raises and exits non-zero.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""
import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs  # noqa: E402  (needs src/ on the path)
from repro_torch.configs.common import concrete_batch  # noqa: E402
from repro_torch.core.pipeline import stage_balance_metrics  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402

ARCH = "qwen3-1.7b"
SEQ = 1024
REQUESTS = 8
STAGES = 4
# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12


def cuda_ms(fn, reps=20):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after
    one warm-up call (inputs stay L2-resident, as on the serving path)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound(q, k, causal):
    """Least time (ms) for one flash-attention call on these inputs: q/k/v
    read and o written once over HBM bandwidth, against 4*D flops per
    unmasked (query, key) pair over the peak rate of the input type."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if causal:      # query i (right-aligned) sees keys 0 .. t - s + i
        pairs = sum(min(t, t - s + i + 1) for i in range(s))
    else:
        pairs = s * t
    flops = 4 * d * pairs * b * hq
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_ops = flops / PEAK_FLOPS[q.dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def attention_inputs(b, hq, hkv, s, t, d, dtype, model_layout=False):
    """Random q/k/v on the card; ``model_layout`` makes them (B, H, S, D)
    views of (B, S, H, D) tensors, as the model's projections are."""
    g = torch.Generator("cuda").manual_seed(0)
    out = []
    for h, n in ((hq, s), (hkv, t), (hkv, t)):
        if model_layout:
            x = torch.randn(b, n, h, d, generator=g, device="cuda",
                            dtype=dtype).transpose(1, 2)
        else:
            x = torch.randn(b, h, n, d, generator=g, device="cuda",
                            dtype=dtype)
        out.append(x)
    return out


def check_flash_attention():
    """Kernel vs plain version at the serving path's widths (Hq 16, Hkv 8,
    D 128).  Returns the main-shape case's record."""
    cases = [  # name, b, hq, hkv, s, t, d, dtype, model layout, tol
        ("bf16 causal S=T=1024, model layout", 1, 16, 8, 1024, 1024, 128,
         torch.bfloat16, True, 2e-2),
        ("bf16 causal ragged S=T=1000", 1, 16, 8, 1000, 1000, 128,
         torch.bfloat16, False, 2e-2),
        ("bf16 causal S=128 T=1024", 1, 16, 8, 128, 1024, 128,
         torch.bfloat16, False, 2e-2),
        ("fp32 causal S=T=1024", 1, 16, 8, 1024, 1024, 128,
         torch.float32, False, 1e-4),
    ]
    record = None
    for name, b, hq, hkv, s, t, d, dtype, layout, tol in cases:
        q, k, v = attention_inputs(b, hq, hkv, s, t, d, dtype, layout)
        got = fa.flash_attention(q, k, v, causal=True)
        expect = flash_attention_ref(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = (got.float() - expect.float()).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        print(f"flash_attention {name}: max_abs_err {err:.3e} "
              f"(tol {tol:g}), finite={finite}")
        if not (finite and err <= tol):
            raise SystemExit(f"flash_attention disagrees with its plain "
                             f"version on {name}: {err:.3e} > {tol:g}")
        if record is None:
            ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True))
            plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, True))
            library_ms = cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True))
            bound_ms, bound_by = attention_bound(q, k, causal=True)
            record = {"name": "flash_attention", "route": "cuda",
                      "source": "src/repro_torch/kernels/csrc/"
                                "flash_attention.cu",
                      "replaces": "src/repro/kernels/flash_attention.py:74",
                      "max_abs_err": err, "ms": ms, "kernel_ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": library_ms,
                      "shape": {"b": b, "hq": hq, "hkv": hkv, "s": s,
                                "t": t, "d": d, "dtype": str(dtype),
                                "causal": True}}
            print(f"flash_attention timing at {name}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by})")
    return record


def check_model_on_card():
    """The smoke-config model (fp32) on the card against the same weights
    on the CPU, where attention is the plain version; tolerance 1e-4
    (summation order over four layers)."""
    cfg = configs.get(ARCH).smoke_config()
    cpu = torch.device("cpu")
    params = lm.init_params(cfg, cpu, torch.Generator(cpu).manual_seed(0))

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_card(v) for v in tree]
        return tree.to("cuda")

    batch = concrete_batch(cfg, 200, 2, kind="prefill")
    got = lm.forward(cfg, to_card(params), batch).cpu()
    expect = lm.forward(cfg, params, batch)
    err = (got - expect).abs().max().item()
    print(f"smoke model, card vs CPU (plain attention): max_abs_err "
          f"{err:.3e} (tol 1e-4)")
    if not (torch.isfinite(got).all() and err <= 1e-4):
        raise SystemExit(f"model on the card disagrees with the CPU: {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libs = _build.build(["flash_attention"])
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "entry function" in line or "Used" in line or "spill" in line:
                print(f"  {name} ptxas: {line.strip()}")

    record = check_flash_attention()
    check_model_on_card()

    args = serve.parse_args(["--arch", ARCH, "--stages", str(STAGES),
                             "--requests", str(REQUESTS), "--seq", str(SEQ),
                             "--strategy", "balanced", "--device", "cuda"])
    fa.reset_launches()
    res = serve.run(args)
    launches = fa.launches
    record["launches"] = launches

    cfg, pl, snap = res["cfg"], res["plan"], res["snapshot"]
    print("plan:", pl.describe())
    print("blocks per stage:", serve.stage_block_counts(pl, cfg.n_layers))
    busy = snap["stage_busy_s"]
    lat = snap["latency"]
    print(f"served {len(res['outs'])} requests of {SEQ} tokens in "
          f"{res['seconds'] * 1e3:.2f} ms: "
          f"{snap['throughput_rps']:.2f} req/s, "
          f"{snap['throughput_rps'] * SEQ:.0f} tokens/s")
    print(f"latency p50/p95 (ms): {lat['p50_s'] * 1e3:.2f} / "
          f"{lat['p95_s'] * 1e3:.2f}")
    print(f"stage busy (s): {[round(b, 5) for b in busy]}, balance "
          f"(mean/max) {stage_balance_metrics(busy)['balance']:.3f}")
    print(f"pipeline vs direct max err: {res['max_err']:.2e}")
    forwards = args.requests + 2        # warm-up, requests, direct reference
    print(f"flash_attention launches: {launches} "
          f"({cfg.n_layers} layers x {forwards} forwards)")

    outs = res["outs"]
    if not all(o.shape == (1, 1, cfg.vocab) and bool(torch.isfinite(o).all())
               for o in outs):
        raise SystemExit("served logits are not finite (1, 1, vocab)")
    if not res["max_err"] < 2e-2:
        raise SystemExit(f"pipeline vs direct {res['max_err']:.2e} >= 2e-2")
    if launches != cfg.n_layers * forwards:
        raise SystemExit(f"flash_attention launched {launches} times, "
                         f"expected {cfg.n_layers * forwards}")

    direct_ms = direct_forward_ms(cfg, res["params"], res["requests"][0])
    print(f"direct forward of one {SEQ}-token request: {direct_ms:.3f} ms; "
          f"{cfg.n_layers} flash_attention calls at {record['ms']:.4f} ms = "
          f"{cfg.n_layers * record['ms'] / direct_ms:.1%} of it")

    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def direct_forward_ms(cfg, params, tokens, reps=5):
    """Host-clock time of one whole-model forward ending in a device
    synchronize (the single-request latency floor of the pipeline)."""
    lm.forward(cfg, params, {"tokens": tokens}, last_token_only=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        lm.forward(cfg, params, {"tokens": tokens}, last_token_only=True)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


if __name__ == "__main__":
    sys.exit(main())
