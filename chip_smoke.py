#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times [--tree DIR]

The second form only builds and times flash_decode, rwkv6_scan and
rglru_scan at the points below (one JSON line), importing the port from
DIR/src (another checkout, such as the parent commit's) when ``--tree`` is
given, so two trees' kernels are timed by the same code on one card.
With no arguments:

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel of the model paths from the sources in this
   checkout (flash_attention, flash_decode, rwkv6_scan, rglru_scan,
   matmul_qi8; one nvcc per source, started together), prints ptxas's
   registers and spills of each kernel (failing if flash_decode,
   rwkv6_scan or rglru_scan spills) and the tensor-core instructions in
   the SASS of bf16 flash_attention and flash_decode (HMMA) and
   matmul_qi8 (IMMA), failing if any of their instantiations has none;
3. holds each kernel against its plain PyTorch version at the shapes the
   model paths give it (the flash kernels also at recurrentgemma's head dim
   256 with 16 q heads per kv head; flash_attention with recurrentgemma's
   window of 2048 at S = T = 4096; matmul_qi8 exactly at 512^3, ResNet50's
   head, a 1x1 conv and a ragged K; flash_decode with lengths ending
   inside a split, rwkv6_scan with decays of 1e-30 and 1; rglru_scan at
   recurrentgemma's S = 1 decode step at B 2 and 16, at S on both sides
   of its route threshold and of its piece edges, at S = 4096, with
   ragged R in fp32 and bf16 and with decays of 1e-30 and 1, one counted
   launch a call, staged results equal bit for bit to the step route's),
   and times kernel, plain version and, where one exists, one library
   call (the yardstick; the port never calls it; no single PyTorch call
   computes either recurrence), with flash_attention's achieved TFLOP/s
   beside SDPA's, flash_decode also at recurrentgemma's full window and
   beside one torch.sum over as many bytes, rwkv6_scan also at S = 1,
   rglru_scan in fp32 and bf16 and at S = 1 (B 2 and 16) beside one
   torch.add over as many bytes;
4. holds the full model on the card against the same model on the CPU at
   the smoke configs of qwen3-1.7b, rwkv6-1.6b and recurrentgemma-9b (the
   CPU runs the plain versions), for a prefill forward and for a greedy
   decode loop through the KV cache or the recurrent state;
5. drives the prefill serving path -- the balanced 4-stage plan of
   full-width qwen3-1.7b with random weights from a seed, 8 streamed
   requests of 1024 tokens -- with every kernel's launch count set to 0
   just before and read just after, checks the output against the direct
   forward, and checks that every layer of every forward went through the
   kernel;
6. drives the decode serving path the same way -- the decode_placement
   4-stage plan of full-width qwen3-1.7b at concurrency 8 and context 2048
   (planned for a device with a quarter of the card's memory per stage),
   16 streams of 1024-token prompts x 64 new tokens through the continuous
   batch -- checks that every decode step's every layer ran flash_decode
   and every prefill's every layer flash_attention, and holds each served
   token of the first streams against the full forward of its stream
   (teacher forcing through the prefill kernel), within the bf16 noise
   measured against an fp32 evaluation; then the same decode path at full
   width in fp32 against its fp32 teacher, within 2e-2;
7. drives rwkv6-1.6b at full width through the model API (random bf16
   weights from seed 0, after printing its 4-stage balanced plan): 4
   prompts of 1024 tokens prefilled into the recurrent state, then 64
   greedy tokens each, with every kernel's count set to 0 just before and
   read just after (rwkv6_scan: 24 layers x decode calls, the others 0);
   the served tokens are teacher-forced as in 6, and the same loop runs in
   fp32 against its fp32 teacher within 2e-2;
8. drives recurrentgemma-9b at full width the same way (bf16 weights from
   seed 0, plan printed, the weights of 7 freed first): one forward of a
   (2, 1024) batch (26 rglru_scan and 12 flash_attention launches) and a
   decode loop of 16 rows, a 32-token prompt fed token by token plus 32
   greedy tokens at max_len 64 (26 rglru_scan and 12 flash_decode launches
   a step), teacher-forced and repeated in fp32 as in 7;
9. the paper's CNN path (fp32, TF32 off): all 21 Table-1 models and
   synthetic_cnn(64) at their published input sizes, one forward each on
   the card against the CPU; ResNet50 planned by the analytic Edge TPU
   model (balanced, 4 stages) and served through ``cnn_stage_fns`` (64
   single-image requests), then profiled depth by depth on the card and
   re-planned from that trace (balanced_cost, ``trace:``) for the
   reference's Edge TPU and for a quarter of the card's memory a stage,
   the three plans served in turn twice, each served output equal to the
   direct forward;
   then the int8 API on ResNet50's head (``quantized_dense``, 1
   matmul_qi8 launch between a reset and a read of the counts);
10. the fault-tolerance tier on ResNet50 (the weights of 9): the placement
   DP's 4-stage cut with its two slowest modeled stages on a second
   device each (6 devices), served through ``cnn_stage_fns`` with
   stage-loss retries, hedging and a ``HealthMonitor`` while a
   ``ChaosMonkey`` kills one replica of each replicated stage and then
   the last replica of the second; the monitor replans the survivors
   through ``ElasticPlanner`` and hot-swaps.  64 requests 15 ms apart: 0
   lost, 0 misordered, every output equal to the direct forward;
11. full-width qwen3-1.7b prefill through ``serve.run`` with
   ``--device-budget 6 --stage-loss-retries 1``, hedging after three
   bottleneck-stage times of 5 and a deadline no request reaches: the
   first output within 2e-2 of the direct forward, flash_attention's
   launches equal to layers x forwards plus the layers of every hedged
   stage execution the executor reports;
12. self-healing on ResNet50: the analytic 4-stage plan served under
   ``dep.self_heal(canaries)``, a ``tick()`` after each of 12 batches of
   8 requests (deterministic in windows): each window's req/s, per-item
   stage busy, drift and state, the controller's commits, rollbacks and
   events, the live trace's per-stage times beside the card trace's (the
   ``vs trace`` form); then the plan the live trace gives, its canary
   cold and warm and the stream served over it and the incumbent in
   turns; every output equal to the direct forward;
13. a fleet of ResNet50 (share 3) and MobileNetV2 (share 1) over 6
   devices, each member served through ``cnn_stage_fns``: 4 windows of
   share-proportional traffic, then 4 with ResNet50's load tripled, the
   autoscaler ticked after each window: the pool split before and after,
   its events, attainment and the audit (0 lost, 0 misordered, every
   output equal to its member's direct forward); the phases 10 to 13
   launch no hand-written kernel but the prefill's flash_attention;
14. prints one JSON line of CNN results, one of the fault-tolerance,
   self-healing and fleet results, one of kernel results, then, as the
   last line, ``{"ok": true, "device": {...}}``.

Any failed phase raises and exits non-zero.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""
import dataclasses
import json
import pathlib
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
# --tree DIR: the port is imported from DIR/src instead of this checkout's
TREE = (pathlib.Path(sys.argv[sys.argv.index("--tree") + 1]).resolve()
        if "--tree" in sys.argv[:-1] else ROOT)
sys.path.insert(0, str(TREE / "src"))

from repro_torch import configs  # noqa: E402  (needs src/ on the path)
from repro_torch.api import Deployment, DeploymentSpec, plan  # noqa: E402
from repro_torch.configs.common import concrete_batch  # noqa: E402
from repro_torch.core.edge_tpu_model import EdgeTPUSpec  # noqa: E402
from repro_torch.core.pipeline import (PipelineExecutor,  # noqa: E402
                                       stage_balance_metrics)
from repro_torch.core.placement import PlacementPlan  # noqa: E402
from repro_torch.decode.engine import PipelineDecodeEngine  # noqa: E402
from repro_torch.fleet import (FleetMemberSpec, FleetSpec,  # noqa: E402
                               deploy_fleet)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import matmul_qi8 as mq  # noqa: E402
from repro_torch.kernels import quant  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rw  # noqa: E402
from repro_torch.kernels.ref import (flash_attention_ref,  # noqa: E402
                                     flash_decode_ref, matmul_qi8_ref,
                                     rglru_scan_ref, rwkv6_scan_ref)
from repro_torch.launch import profile_serve, serve  # noqa: E402
from repro_torch.models import api, cnn, lm, lm_graph  # noqa: E402
from repro_torch.profiling import profile_model  # noqa: E402
from repro_torch.runtime import (ChaosEvent, ChaosMonkey,  # noqa: E402
                                 ElasticPlanner, FaultPolicy,
                                 HealthMonitor)

KERNELS = ("flash_attention", "flash_decode", "rwkv6_scan", "rglru_scan",
           "matmul_qi8")
# the kernels --kernel-times builds and times (the latest redesigns)
TIMED = ("flash_decode", "rwkv6_scan", "rglru_scan")
# each kernel's design, as its source note sets it out
DESIGNS = {
    "flash_attention": "bf16: mma.sync m16n8k16 (fp32 accumulate), "
                       "ldmatrix / ldmatrix.trans, cp.async 2-stage K/V "
                       "ring (one barrier a tile), P in registers, 4 warps "
                       "x 16 q rows, heavy and light causal tiles paired "
                       "on each SM; fp32: CUDA cores, 64 x 64 tiles, 256 "
                       "threads",
    "flash_decode": "bf16: mma.sync m16n8k16 (fp32 accumulate), one block "
                    "of 4 warps per (split, kv head, row) serving up to 16 "
                    "q heads, a cp.async ring per warp of 16-key tiles, P "
                    "in registers, splits from the SM count cut each row's "
                    "length, a combine pass; fp32: CUDA cores, 16-byte row "
                    "slices",
    "rwkv6_scan": "CUDA cores: 256 threads per (head, row), the state split "
                  "over 256 / D threads a column (a warp on one part, y's "
                  "partial sums through shared memory), rows staged 64 "
                  "steps a chunk by cp.async, double-buffered",
    "rglru_scan": "CUDA cores: S >= 64 on the staged route, one block of "
                  "256 threads per (128-byte tile row, batch row) copying "
                  "S in 64-step pieces by 16-byte cp.async, 3 in flight, "
                  "one thread a channel scanning each piece in order out "
                  "of shared memory; S < 64 (the decode step) one thread "
                  "per channel; both routes the same FMAs in the same "
                  "order",
    "matmul_qi8": "mma.sync m16n8k32 s8 -> s32, cp.async 2-stage x ring, w "
                  "transposed by prmt on load, 64 x 64 or 16 x 64 tiles, "
                  "split-K with int32 atomics",
}

ARCH = "qwen3-1.7b"
SEQ = 1024
REQUESTS = 8
STAGES = 4
# the decode run: slots x context of the plan, streams x new tokens
DECODE_SLOTS = 8
DECODE_CONTEXT = 2048
DECODE_STREAMS = 16
DECODE_NEW = 64
TEACHER_STREAMS = 4
TEACHER_TOL = 2e-2
TEACHER_AGREE = 0.9     # share of served bf16 tokens = the teacher's argmax
# fewest positions where bf16 resolves the teacher's argmax (the recurrent
# families' agreement rule counts only those; fewer fails the check)
TEACHER_MIN_DECISIVE = 24
# per-slot lengths of the kernel check: empty, one, block edges, ragged,
# the path's range, full
DECODE_LENS = [0, 1, 127, 128, 1000, 1088, 2047, 2048]
# the timed point: every slot mid-stream of the decode run (1024-token
# prompts, 1 to 64 generated tokens)
DECODE_TIMED_LEN = 1056
COLD_SETS = 8           # distinct cache sets the kernel timing rotates over
BACKLOG_CYCLES = 100_000_000    # ~50 ms of device sleep while the host queues
# the recurrent families' runs
RWKV_ARCH = "rwkv6-1.6b"
RWKV_STREAMS = 4
RWKV_PROMPT = 1024
RWKV_NEW = 64
GEMMA_ARCH = "recurrentgemma-9b"
GEMMA_FORWARD = (2, 1024)       # batch, tokens of the timed forward
GEMMA_ROWS = 16         # decode rows: enough served tokens that bf16
                        # resolves the argmax at TEACHER_MIN_DECISIVE of them
GEMMA_PROMPT = 32
GEMMA_NEW = 32
GEMMA_MAX_LEN = 64
# recurrentgemma's windowed prefill above local_window: B, Hq, Hkv, S = T,
# D, window
WINDOWED = (1, 16, 1, 4096, 256, 2048)
# matmul_qi8: 512^3 (benchmarks/kernel_bench.py); ResNet50's head as a GEMM
# (the int8 path's shape: 8 images x 2048 features x 1000 classes); a 1x1
# conv as a GEMM (8 x 56 x 56 pixels, 64 -> 256 channels); a ragged K
QI8_SHAPES = ((512, 512, 512), (8, 2048, 1000), (8 * 56 * 56, 64, 256),
              (1000, 30, 300))
QI8_HEAD = (8, 2048, 1000)
# the CNN path: the analytic plan of paper Table 5 / examples/quickstart.py,
# then the same model planned from its own trace on the card
CNN = "ResNet50"
CNN_REQUESTS = 64
CNN_ROUNDS = 2          # every plan served in turn, twice: host noise shows
CNN_TOL = 1e-4          # card vs CPU forward, relative to max |y|
# the fault-tolerance, self-healing and fleet phases (ResNet50's weights of
# the CNN path, fp32): devices of the replicated plan and of the fleet's
# pool; the chaos stream's spacing and kill times (two replicas, then the
# last replica of one stage); a heartbeat timeout far above any stage time
FT_BUDGET = 6
FT_INTERVAL_S = 0.015
FT_KILL_AT_S = (0.15, 0.30, 0.45)
FT_HEARTBEAT_S = 10.0
FT_HEDGE_X = 3          # hedge after this many bottleneck-stage times
FT_DEADLINE_MS = 60_000.0       # a deadline no request should reach
# self-healing: batches of the stream, one tick() after each
HEAL_BATCHES = 12
HEAL_BATCH = 8
HEAL_CANARIES = 4
HEAL_DRIFT = 0.3
# the fleet: (member, Table-1 model, share, p95 SLO ms), windows a phase
FLEET = (("resnet50", "ResNet50", 3.0, 100.0),
         ("mobilenetv2", "MobileNetV2", 1.0, 50.0))
FLEET_WINDOWS = 4
FLEET_POOL = 16         # distinct images a member's requests cycle over
# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 CUDA cores, int8
# tensor cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}
HBM_BYTES_PER_S = 3.35e12


def cuda_ms(fns, reps=20, backlog=True):
    """Mean time of one call over ``reps`` calls that rotate over ``fns``
    (one function: L2-warm inputs, as the prefill path's just-written
    projections; several, each on its own inputs together larger than the
    50 MB L2: reads from HBM, as on the decode path), after one warm-up
    round.  ``backlog``: the card first sleeps while the host enqueues
    every call, so the events time the device alone; else the calls run
    as the host issues them (a call's host time bounds it)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if backlog:
        torch.cuda._sleep(BACKLOG_CYCLES)
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tensor_core_ops(path, op, kernel):
    """SASS instructions ``op`` (HMMA, IMMA) in each function of the built
    library at ``path`` whose name holds ``kernel``, by ``cuobjdump
    -sass``: name -> count."""
    cuobjdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return {fn.split("\n", 1)[0].strip(): len(re.findall(rf"\s{op}\.", fn))
            for fn in sass.split("Function : ")[1:]
            if kernel in fn.split("\n", 1)[0]}


def attention_flops(q, k, causal, window=None):
    """4*D flops per unmasked (query, key) pair: the work of one call."""
    b, hq, s, d = q.shape
    t = k.shape[2]
    if causal:      # query i (right-aligned) sees keys 0 .. t - s + i
        pairs = sum(min(t, t - s + i + 1, window or t) for i in range(s))
    else:
        pairs = s * t
    return 4 * d * pairs * b * hq


def attention_bound(q, k, causal, window=None):
    """Least time (ms) for one flash-attention call on these inputs: q/k/v
    read and o written once over HBM bandwidth, against 4*D flops per
    unmasked (query, key) pair over the peak rate of the input type."""
    flops = attention_flops(q, k, causal, window)
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


def tflops(q, k, ms, window=None):
    """Achieved TFLOP/s of a causal call that took ``ms``: the bound's
    operation count over the time."""
    return attention_flops(q, k, True, window) / (ms * 1e-3) / 1e12


def time_attention(q, k, v):
    """Kernel, plain version and SDPA (ms), and the bound, on one input."""
    ms = cuda_ms([lambda: fa.flash_attention(q, k, v, causal=True)])
    plain_ms = cuda_ms([lambda: flash_attention_ref(q, k, v, True)])
    library_ms = cuda_ms([
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)])
    bound_ms, bound_by = attention_bound(q, k, causal=True)
    return {"ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "tflops": tflops(q, k, ms),
            "library_tflops": tflops(q, k, library_ms)}


def check_flash_attention():
    """Kernel vs plain version at the prefill path's widths (Hq 16, Hkv 8,
    D 128) and at recurrentgemma's (Hq 16, Hkv 1, D 256).  Returns the
    record of the qwen3 shape, with the D 256 shape's times under
    ``d256``."""
    cases = [  # name, b, hq, hkv, s, t, d, dtype, model layout, tol
        ("bf16 causal S=T=1024, model layout", 1, 16, 8, 1024, 1024, 128,
         torch.bfloat16, True, 2e-2),
        ("bf16 causal ragged S=T=1000", 1, 16, 8, 1000, 1000, 128,
         torch.bfloat16, False, 2e-2),
        ("bf16 causal S=128 T=1024", 1, 16, 8, 128, 1024, 128,
         torch.bfloat16, False, 2e-2),
        ("fp32 causal S=T=1024", 1, 16, 8, 1024, 1024, 128,
         torch.float32, False, 1e-4),
        ("bf16 D=256 MQA 16:1 causal B=2 S=T=1024, model layout", 2, 16, 1,
         1024, 1024, 256, torch.bfloat16, True, 2e-2),
        ("fp32 D=256 MQA 16:1 causal ragged S=T=520", 1, 16, 1, 520, 520,
         256, torch.float32, False, 1e-4),
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
        shape = {"b": b, "hq": hq, "hkv": hkv, "s": s, "t": t, "d": d,
                 "dtype": str(dtype), "causal": True}
        if record is None or (d == 256 and layout):
            times = time_attention(q, k, v)
            print(f"flash_attention timing at {name}: kernel "
                  f"{times['ms']:.4f} ms ({times['tflops']:.1f} TFLOP/s), "
                  f"plain {times['plain_ms']:.4f} ms, sdpa "
                  f"{times['library_ms']:.4f} ms "
                  f"({times['library_tflops']:.1f} TFLOP/s), bound "
                  f"{times['bound_ms']:.4f} ms ({times['bound_by']})")
            if record is None:
                record = {"name": "flash_attention", "route": "cuda",
                          "source": "src/repro_torch/kernels/csrc/"
                                    "flash_attention.cu",
                          "replaces": "src/repro/kernels/"
                                      "flash_attention.py:74",
                          "max_abs_err": err, **times, "shape": shape}
            else:
                record["d256"] = {"max_abs_err": err, **times,
                                  "shape": shape}
        elif dtype == torch.float32 and d == 128:
            # the CUDA-core route, beside the bf16 route's times
            ms = cuda_ms([lambda: fa.flash_attention(q, k, v, causal=True)])
            record["fp32"] = {"max_abs_err": err, "ms": ms,
                              "tflops": tflops(q, k, ms), "shape": shape}
            print(f"flash_attention timing at {name}: kernel {ms:.4f} ms "
                  f"({record['fp32']['tflops']:.1f} TFLOP/s)")
    return record


def decode_bound(q, k, lens):
    """Least time (ms) for one flash-decode call on these inputs: q read, o
    written and each slot's valid K/V rows read once over HBM bandwidth,
    against 4*D flops per valid (q head, position) over the peak rate of
    the input type."""
    b, hq, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    positions = int(lens.clamp(0, t).sum())
    flops = 4 * d * hq * positions
    nbytes = (2 * q.numel() + 2 * hkv * positions * d) * q.element_size()
    t_ops = flops / PEAK_FLOPS[q.dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def decode_inputs(b, hq, hkv, t, d, dtype, model_layout=False, seed=0):
    """Random q (B, Hq, D) and k/v caches (B, Hkv, T, D) on the card;
    ``model_layout`` makes the caches (B, Hkv, T, D) views of (B, T, Hkv,
    D) tensors, as the decode engine's layer caches are."""
    g = torch.Generator("cuda").manual_seed(seed)
    q = torch.randn(b, hq, d, generator=g, device="cuda", dtype=dtype)
    kv = []
    for _ in range(2):
        if model_layout:
            x = torch.randn(b, t, hkv, d, generator=g, device="cuda",
                            dtype=dtype).transpose(1, 2)
        else:
            x = torch.randn(b, hkv, t, d, generator=g, device="cuda",
                            dtype=dtype)
        kv.append(x)
    return q, kv[0], kv[1]


def time_decode(sets, lens, reps=40):
    """Kernel (device time, and as the host issues the calls), plain
    version, SDPA and one torch.sum over as many bytes as the valid K/V
    rows (ms), and the bound, rotating over cache sets."""
    t = sets[0][1].shape[2]
    valid = (torch.arange(t, device="cuda")[None, :]
             < lens[:, None])[:, None, None, :]
    kernel = [lambda s=s: fd.flash_decode(*s, lens) for s in sets]
    ms = cuda_ms(kernel, reps=reps)
    bound_ms, bound_by = decode_bound(sets[0][0], sets[0][1], lens)
    # the reach of one plain read pass: torch.sum over contiguous tensors
    # of as many bytes as the valid K/V rows, rotated as the caches are
    n = int(lens.clamp(0, t).sum()) * 2 * sets[0][1].shape[1] * \
        sets[0][1].shape[3]
    flat = [torch.ones(n, dtype=sets[0][1].dtype, device="cuda")
            for _ in sets]
    stream_ms = cuda_ms([lambda x=x: x.sum() for x in flat], reps=reps)
    del flat
    return {"ms": ms, "kernel_ms": ms, "stream_ms": stream_ms,
            "issued_ms": cuda_ms(kernel, reps=reps, backlog=False),
            "plain_ms": cuda_ms([lambda s=s: flash_decode_ref(*s, lens)
                                 for s in sets], reps=reps),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": cuda_ms([
                lambda s=s: torch.nn.functional.scaled_dot_product_attention(
                    s[0][:, :, None], s[1], s[2], attn_mask=valid,
                    enable_gqa=True)
                for s in sets], reps=reps)}


def check_flash_decode():
    """Kernel vs plain version at the decode path's widths (B 8, Hq 16,
    Hkv 8, D 128, T 2048) with per-slot lengths, plus fp32, MQA and D 16
    cases, and recurrentgemma's D 256 with 16 q heads per kv head; rows of
    length 0 must be zeros.  Then times kernel, plain version and SDPA at
    the qwen3 decode path's point and at recurrentgemma's (under
    ``d256``), rotating over cache sets.  Returns the kernel's record."""
    cases = [  # name, b, hq, hkv, t, d, dtype, model layout, lengths, tol
        ("bf16 B=8 T=2048, model layout, per-slot lengths", 8, 16, 8, 2048,
         128, torch.bfloat16, True, DECODE_LENS, 2e-2),
        ("fp32 B=8 T=2048, per-slot lengths", 8, 16, 8, 2048, 128,
         torch.float32, False, DECODE_LENS, 1e-5),
        ("fp32 MQA group 8, D=64 T=1000, per-slot lengths", 4, 8, 1, 1000,
         64, torch.float32, False, [1, 255, 999, 1000], 1e-5),
        ("bf16 D=16 T=300, model layout, scalar length 200", 2, 4, 2, 300,
         16, torch.bfloat16, True, 200, 2e-2),
        ("bf16 D=256 MQA group 16, B=8 T=2048, model layout, per-slot "
         "lengths", 8, 16, 1, 2048, 256, torch.bfloat16, True, DECODE_LENS,
         2e-2),
        ("fp32 D=256 MQA group 16, B=8 T=2048, per-slot lengths", 8, 16, 1,
         2048, 256, torch.float32, False, DECODE_LENS, 1e-5),
        ("bf16 group 2 B=8 T=2048, model layout, lengths ending inside a "
         "split", 8, 16, 8, 2048, 128, torch.bfloat16, True,
         [0, 200, 223, 225, 500, 1056, 1057, 1999], 2e-2),
        ("bf16 D=256 group 16, B=16 T=64, model layout, per-slot lengths",
         16, 16, 1, 64, 256, torch.bfloat16, True,
         [0, 1, 15, 16, 17, 33, 63, 64] * 2, 2e-2),
        ("bf16 D=256 group 16, B=16 T=2048, model layout, lengths 2048 and "
         "inside a split", 16, 16, 1, 2048, 256, torch.bfloat16, True,
         [2048] * 8 + [0, 1, 100, 127, 129, 1000, 2047, 2048], 2e-2),
    ]
    record = None
    for name, b, hq, hkv, t, d, dtype, layout, lens, tol in cases:
        q, k, v = decode_inputs(b, hq, hkv, t, d, dtype, layout)
        arg = (lens if isinstance(lens, int) else
               torch.tensor(lens, dtype=torch.int32, device="cuda"))
        got = fd.flash_decode(q, k, v, arg)
        expect = flash_decode_ref(q, k, v, arg)
        torch.cuda.synchronize()
        live = torch.as_tensor(lens, device="cuda").expand(b) > 0
        err = (got[live].float() - expect[live].float()).abs().max().item()
        zeros = bool((got[~live] == 0).all())
        finite = bool(torch.isfinite(got).all())
        print(f"flash_decode {name}: max_abs_err {err:.3e} (tol {tol:g}), "
              f"length-0 rows zero={zeros}, finite={finite}")
        if not (finite and zeros and err <= tol):
            raise SystemExit(f"flash_decode disagrees with its plain "
                             f"version on {name}: {err:.3e} > {tol:g} or "
                             f"nonzero length-0 rows")
        if record is None:
            record = {"max_abs_err": err}

    times = time_decode_points()
    record.update({
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:62",
        **times["qwen3"]})
    record["d256"] = times["d256"]
    record["d256_full"] = times["d256_full"]
    return record


DECODE_POINTS = {  # b, hq, hkv, t, d, timed length
    "qwen3": (8, 16, 8, DECODE_CONTEXT, 128, DECODE_TIMED_LEN),
    "d256": (GEMMA_ROWS, 16, 1, GEMMA_MAX_LEN, 256, GEMMA_MAX_LEN),
    # recurrentgemma's window when full
    "d256_full": (GEMMA_ROWS, 16, 1, 2048, 256, 2048)}


def time_decode_points():
    """Kernel, plain version and SDPA at the qwen3 decode path's point, at
    recurrentgemma's decode loop's (T 64) and at its full window (T 2048),
    bf16 in the model layout, rotating over cache sets."""
    out = {}
    for key, (b, hq, hkv, t, d, n) in DECODE_POINTS.items():
        lens = torch.full((b,), n, dtype=torch.int32, device="cuda")
        sets = [decode_inputs(b, hq, hkv, t, d, torch.bfloat16, True, seed=i)
                for i in range(COLD_SETS)]
        times = time_decode(sets, lens)
        times["shape"] = {"b": b, "hq": hq, "hkv": hkv, "t": t, "d": d,
                          "dtype": str(torch.bfloat16), "lens": n,
                          "cache_sets": COLD_SETS}
        print(f"flash_decode timing at B={b} Hq={hq} Hkv={hkv} D={d} T={t} "
              f"len={n} (bf16, model layout, {COLD_SETS} cache sets): "
              f"kernel {times['ms']:.4f} ms ({times['issued_ms']:.4f} ms a "
              f"call as the host issues them), plain "
              f"{times['plain_ms']:.4f} ms, sdpa {times['library_ms']:.4f} "
              f"ms, bound {times['bound_ms']:.4f} ms ({times['bound_by']}), "
              f"one torch.sum over as many bytes {times['stream_ms']:.4f} "
              f"ms")
        out[key] = times
        del sets
        torch.cuda.empty_cache()
    return out


def allclose_err(got, expect, tol):
    """Largest |got - expect| and whether every element lies within
    tol * (1 + |expect|) (the CPU tests' rtol = atol = tol) and is
    finite."""
    g, e = got.float(), expect.float()
    diff = (g - e).abs()
    ok = bool(torch.isfinite(g).all()) and bool(
        (diff <= tol * (1 + e.abs())).all())
    return diff.max().item(), ok


def scan_bound(nbytes, flops):
    t_ops = flops / PEAK_FLOPS[torch.float32]      # CUDA-core arithmetic
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def rwkv6_inputs(b, h, s, d, dtype, model_layout, seed=0):
    """r, k, v, w (B, H, S, D) on the card with the reference tests'
    spread (k 0.2 N, w in (0.7, 1)), u (H, D) and a nonzero s0;
    ``model_layout`` makes r/k/v/w views of (B, S, H, D) tensors."""
    g = torch.Generator("cuda").manual_seed(seed)

    def bshd(scale=1.0, uniform=False):
        shape = (b, s, h, d) if model_layout else (b, h, s, d)
        x = (0.7 + 0.3 * torch.rand(shape, generator=g, device="cuda")
             if uniform else
             scale * torch.randn(shape, generator=g, device="cuda"))
        x = x.to(dtype)
        return x.transpose(1, 2) if model_layout else x

    r, k, v, w = bshd(), bshd(0.2), bshd(), bshd(uniform=True)
    u = 0.2 * torch.randn(h, d, generator=g, device="cuda")
    s0 = 0.1 * torch.randn(b, h, d, d, generator=g, device="cuda")
    return r, k, v, w, u, s0


def check_rwkv6_scan():
    """Kernel vs plain version at rwkv6-1.6b's shape (B 4, H 32, S 1024, D
    64, fp32, the model's (B, S, H, D) layout, nonzero s0), in bf16, at the
    decode step S = 1, ragged S, the smaller head dims and the extreme
    decays (w 1e-30 and 1); y and s_last within tol (1 + |plain|).  Times
    kernel and plain version at the main shape and at S = 1.  Returns the
    kernel's record."""
    cases = [  # name, b, h, s, d, dtype, model layout, tol
        ("fp32 B=4 H=32 S=1024 D=64, model layout", 4, 32, 1024, 64,
         torch.float32, True, 2e-4),
        ("bf16 B=4 H=32 S=1024 D=64, model layout", 4, 32, 1024, 64,
         torch.bfloat16, True, 2e-2),
        ("fp32 S=1 (decode step), model layout", 4, 32, 1, 64,
         torch.float32, True, 2e-4),
        ("fp32 ragged S=1000", 2, 32, 1000, 64, torch.float32, False, 2e-4),
        ("fp32 D=32 S=257", 2, 4, 257, 32, torch.float32, False, 2e-4),
        ("bf16 D=16 S=300, model layout", 2, 4, 300, 16, torch.bfloat16,
         True, 2e-2),
        ("fp32 S=31, decays 1e-30 and 1, model layout", 4, 32, 31, 64,
         torch.float32, True, 2e-4),
    ]
    record = None
    for name, b, h, s, d, dtype, layout, tol in cases:
        x = rwkv6_inputs(b, h, s, d, dtype, layout)
        if "decays" in name:      # alternate steps at the two extremes
            x[3][:, :, 0::2] = 1e-30
            x[3][:, :, 1::2] = 1.0
        y, s_last = rw.rwkv6_scan(*x)
        y_ref, s_ref = rwkv6_scan_ref(*x)
        torch.cuda.synchronize()
        err_y, ok_y = allclose_err(y, y_ref, tol)
        err_s, ok_s = allclose_err(s_last, s_ref, tol)
        print(f"rwkv6_scan {name}: max_abs_err y {err_y:.3e}, s_last "
              f"{err_s:.3e} (within {tol:g} (1 + |plain|): {ok_y and ok_s})")
        if not (ok_y and ok_s):
            raise SystemExit(f"rwkv6_scan disagrees with its plain version "
                             f"on {name}: {err_y:.3e}, {err_s:.3e}")
        if record is None:
            record = {"max_abs_err": max(err_y, err_s)}
        del x
    times = time_rwkv6_points()
    record.update({"name": "rwkv6_scan", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                   "replaces": "src/repro/kernels/rwkv6_scan.py:53",
                   **times["main"], "s1": times["s1"]})
    return record


RWKV_POINTS = {"main": (4, 32, 1024, 64),   # b, h, s, d: rwkv6-1.6b's
               "s1": (4, 32, 1, 64)}        # forward and its decode step


def time_rwkv6_points():
    """Kernel and plain version (ms) and the bound at rwkv6-1.6b's forward
    shape and its S = 1 decode step, fp32 in the model layout (the kernel
    timed L2-warm, as the model's just-written projections)."""
    out = {}
    for key, (b, h, s, d) in RWKV_POINTS.items():
        x = rwkv6_inputs(b, h, s, d, torch.float32, True)
        ms = cuda_ms([lambda: rw.rwkv6_scan(*x)])
        plain_ms = cuda_ms([lambda: rwkv6_scan_ref(*x)], reps=3)
        nbytes = 5 * b * h * s * d * 4 + 2 * b * h * d * d * 4
        bound_ms, bound_by = scan_bound(nbytes, 4 * b * h * s * d * d)
        out[key] = {"ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": None,
                    "shape": {"b": b, "h": h, "s": s, "d": d,
                              "dtype": str(torch.float32)}}
        print(f"rwkv6_scan timing at B={b} H={h} S={s} D={d} (fp32, model "
              f"layout): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}); no single PyTorch call "
              f"computes it")
        del x
    return out


def rglru_inputs(b, s, r, dtype, seed=0):
    """a in (0.3, 1), g 0.2 N and a nonzero h0 on the card."""
    g = torch.Generator("cuda").manual_seed(seed)
    a = (0.3 + 0.7 * torch.rand(b, s, r, generator=g, device="cuda")
         ).to(dtype)
    gx = (0.2 * torch.randn(b, s, r, generator=g, device="cuda")).to(dtype)
    return a, gx, torch.randn(b, r, generator=g, device="cuda")


def rglru_cases():
    """(name, b, s, r, dtype, tol) of the kernel check: the model's shape
    in fp32 and bf16, the decode step at the two batch sizes of the paths,
    S on both sides of the route threshold and of the staged route's piece
    edges, prompts above recurrentgemma's 2048 window, ragged R (a partial
    tile; rows off 16 bytes, which take the step route), and the extreme
    decays."""
    piece = rg.STAGED.piece
    low = rg.STAGED_MIN_S
    f32, b16 = torch.float32, torch.bfloat16
    cases = [
        ("fp32 B=2 S=1024 R=4096", 2, 1024, 4096, f32, 1e-5),
        ("bf16 B=2 S=1024 R=4096", 2, 1024, 4096, b16, 2e-2),
        ("fp32 S=1 (decode step)", 2, 1, 4096, f32, 1e-5),
        ("fp32 S=1 B=16 (decode loop)", 16, 1, 4096, f32, 1e-5),
        ("fp32 ragged S=1000 R=1000", 3, 1000, 1000, f32, 1e-5),
        ("bf16 ragged S=300 R=1000", 3, 300, 1000, b16, 2e-2),
        ("fp32 S=300 R=1001 (rows off 16 bytes)", 2, 300, 1001, f32, 1e-5),
        ("fp32 S=4096 B=1 (prompt above the window)", 1, 4096, 4096, f32,
         1e-5),
        ("bf16 S=4096 B=1 (prompt above the window)", 1, 4096, 4096, b16,
         2e-2),
        ("fp32 S=1024, decays 1e-30 and 1", 2, 1024, 4096, f32, 1e-5),
        ("fp32 S=4096 B=1, decays 1e-30 and 1", 1, 4096, 4096, f32, 1e-5),
    ]
    for s in sorted({low - 1, low, piece - 1, piece + 1, 2 * piece - 1,
                     2 * piece + 1}):
        cases.append((f"fp32 S={s} (staged from {low}, pieces of {piece})",
                      2, s, 4096, f32, 1e-5))
    return cases


def check_rglru_scan():
    """Kernel vs plain version on every case of :func:`rglru_cases`; y and
    h_last within tol (1 + |plain|), one counted launch a call, and on the
    staged route equal bit for bit to the step route.  Times kernel, plain
    version and one torch.add over the same bytes at the points of
    :func:`time_rglru_points`.  Returns the kernel's record."""
    record = None
    for name, b, s, r, dtype, tol in rglru_cases():
        a, gx, h0 = rglru_inputs(b, s, r, dtype)
        if "decays" in name:
            # even channels decay 1 (a plain running sum over all of S), odd
            # channels 1e-30 and 1 on alternate steps
            a[..., 0::2] = 1.0
            a[:, 0::2, 1::2] = 1e-30
            a[:, 1::2, 1::2] = 1.0
        before = _build.launches("rglru_scan")
        y, h_last = rg.rglru_scan(a, gx, h0)
        calls = _build.launches("rglru_scan") - before
        y_ref, h_ref = rglru_scan_ref(a, gx, h0)
        plan = rg.scan_plan(s, r, a.element_size())
        same = True
        if plan.route == "staged":
            y_step, h_step = rg.launch(a, gx, h0, rg.STEP)
            same = bool(torch.equal(y, y_step)) and bool(
                torch.equal(h_last, h_step))
        torch.cuda.synchronize()
        err_y, ok_y = allclose_err(y, y_ref, tol)
        err_h, ok_h = allclose_err(h_last, h_ref, tol)
        print(f"rglru_scan {name} ({plan.route} route): max_abs_err y "
              f"{err_y:.3e}, h_last {err_h:.3e} (within {tol:g} (1 + "
              f"|plain|): {ok_y and ok_h}), counted launches {calls}, equal "
              f"to the step route: {same}")
        if not (ok_y and ok_h and same) or calls != 1:
            raise SystemExit(f"rglru_scan disagrees with its plain version "
                             f"or its step route on {name}: {err_y:.3e}, "
                             f"{err_h:.3e}, equal {same}, or counted {calls} "
                             f"launches, not 1")
        if record is None:
            record = {"max_abs_err": max(err_y, err_h)}
        del a, gx, y, y_ref
    times = time_rglru_points()
    record.update({"name": "rglru_scan", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
                   "replaces": "src/repro/kernels/rglru_scan.py:47",
                   **times["main"],
                   **{k: v for k, v in times.items() if k != "main"}})
    return record


# b, s, r, dtype: recurrentgemma-9b's (2, 1024) forward in fp32 (the model
# casts to fp32 before the scan) and in bf16, its decode step at the
# forward's batch and at the decode loop's 16 rows
RGLRU_POINTS = {"main": (2, 1024, 4096, torch.float32),
                "bf16": (2, 1024, 4096, torch.bfloat16),
                "s1": (2, 1, 4096, torch.float32),
                "s1_b16": (16, 1, 4096, torch.float32)}


def time_rglru_points():
    """Kernel and plain version (ms), the bound, and one torch.add(a, g,
    out=y) over the same bytes (the reach of one plain elementwise pass of
    this size; not a library call of the recurrence, which has none) at
    each point of RGLRU_POINTS, L2-warm as the model's just-written
    gates."""
    out = {}
    for key, (b, s, r, dtype) in RGLRU_POINTS.items():
        a, gx, h0 = rglru_inputs(b, s, r, dtype)
        ms = cuda_ms([lambda: rg.rglru_scan(a, gx, h0)])
        plain_ms = cuda_ms([lambda: rglru_scan_ref(a, gx, h0)],
                           reps=3 if s > 1 else 20)
        y = torch.empty_like(a)
        stream_ms = cuda_ms([lambda: torch.add(a, gx, out=y)])
        nbytes = 3 * b * s * r * a.element_size() + 2 * b * r * 4
        bound_ms, bound_by = scan_bound(nbytes, 2 * b * s * r)
        plan = (rg.scan_plan(s, r, a.element_size())._asdict()
                if hasattr(rg, "scan_plan") else None)
        out[key] = {"ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
                    "stream_ms": stream_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None, "plan": plan,
                    "shape": {"b": b, "s": s, "r": r, "dtype": str(dtype)}}
        print(f"rglru_scan timing at B={b} S={s} R={r} ({dtype}, plan "
              f"{plan}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), one torch.add over the same "
              f"bytes {stream_ms:.4f} ms; no single PyTorch call computes "
              f"it")
        del a, gx, y
    return out


def check_windowed_flash_attention():
    """recurrentgemma's windowed prefill above its window: the kernel with
    ``window=`` against its plain version at B 1, 16/1 heads, D 256, S = T
    = 4096, window 2048, in bf16 and fp32; then times the windowed kernel,
    the same kernel without the window, the plain version and SDPA with
    the window's boolean mask (bf16).  Returns the record."""
    b, hq, hkv, n, d, window = WINDOWED
    out = {"shape": {"b": b, "hq": hq, "hkv": hkv, "s": n, "t": n, "d": d,
                     "window": window}}
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        q, k, v = attention_inputs(b, hq, hkv, n, n, d, dtype, True)
        got = fa.flash_attention(q, k, v, causal=True, window=window)
        expect = flash_attention_ref(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        err = (got.float() - expect.float()).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        print(f"flash_attention windowed {dtype} B={b} {hq}/{hkv} D={d} "
              f"S=T={n} window={window}: max_abs_err {err:.3e} (tol "
              f"{tol:g}), finite={finite}")
        if not (finite and err <= tol):
            raise SystemExit(f"windowed flash_attention disagrees with its "
                             f"plain version ({dtype}): {err:.3e} > {tol:g}")
        out[f"max_abs_err_{str(dtype).split('.')[-1]}"] = err
        del expect
    # q, k, v are fp32 here; time the bf16 model's call
    q, k, v = attention_inputs(b, hq, hkv, n, n, d, torch.bfloat16, True)
    pos = torch.arange(n, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                             > pos[:, None] - window)
    out["ms"] = cuda_ms([lambda: fa.flash_attention(q, k, v, causal=True,
                                                    window=window)])
    out["causal_ms"] = cuda_ms([lambda: fa.flash_attention(q, k, v,
                                                           causal=True)])
    out["plain_ms"] = cuda_ms([lambda: flash_attention_ref(
        q, k, v, causal=True, window=window)], reps=3)
    out["library_ms"] = cuda_ms([
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)])
    out["bound_ms"], out["bound_by"] = attention_bound(q, k, True, window)
    out["tflops"] = tflops(q, k, out["ms"], window)
    out["library_tflops"] = tflops(q, k, out["library_ms"], window)
    print(f"flash_attention windowed timing (bf16): kernel {out['ms']:.4f} "
          f"ms ({out['tflops']:.1f} TFLOP/s; without the window "
          f"{out['causal_ms']:.4f} ms), plain "
          f"{out['plain_ms']:.4f} ms, sdpa with the mask "
          f"{out['library_ms']:.4f} ms ({out['library_tflops']:.1f} "
          f"TFLOP/s), bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']})")
    return out


def qi8_bound(m, k, n):
    """Least time (ms) of an int8 (M,K) x (K,N) -> int32 product: x and w
    read and the int32 output written once over HBM bandwidth, against
    2*M*N*K operations at the int8 tensor-core peak."""
    t_ops = 2 * m * n * k / PEAK_FLOPS[torch.int8]
    t_bytes = (m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def int_mm_ms(x, w):
    """``torch._int_mm``'s time (the library call: the port never calls
    it), or None with the reason where its shape rules refuse the
    shape."""
    try:
        torch._int_mm(x, w)
    except RuntimeError as e:
        return None, str(e).strip().splitlines()[0]
    return cuda_ms([lambda: torch._int_mm(x, w)]), None


def check_matmul_qi8():
    """Kernel vs plain version (float64 on the card, exact here) at every
    QI8_SHAPES entry, the extremes -128 x -128 included: exactly equal.
    Times kernel, plain version and ``torch._int_mm`` at each.  Returns
    the record of the head shape (QI8_HEAD), the others under
    ``shapes``."""
    record, shapes = None, []
    for m, k, n in QI8_SHAPES:
        g = torch.Generator("cuda").manual_seed(m + k + n)
        x = torch.randint(-128, 128, (m, k), generator=g, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (k, n), generator=g, device="cuda",
                          dtype=torch.int8)
        x[0], w[:, 0] = -128, -128
        got = mq.matmul_qi8(x, w)
        expect = matmul_qi8_ref(x, w)
        torch.cuda.synchronize()
        err = (got.long() - expect.long()).abs().max().item()
        print(f"matmul_qi8 M={m} K={k} N={n}: max_abs_err {err} (must be "
              f"0), dtype {got.dtype}")
        if not (got.dtype == torch.int32 and torch.equal(got, expect)):
            raise SystemExit(f"matmul_qi8 differs from its plain version at "
                             f"{(m, k, n)}: {err}")
        lib_ms, lib_why = int_mm_ms(x, w)
        bound_ms, bound_by = qi8_bound(m, k, n)
        row = {"m": m, "k": k, "n": n, "max_abs_err": err,
               "ms": cuda_ms([lambda: mq.matmul_qi8(x, w)]),
               "plain_ms": cuda_ms([lambda: matmul_qi8_ref(x, w)]),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": lib_ms}
        if lib_why:
            row["library_null_reason"] = f"torch._int_mm: {lib_why}"
        print(f"matmul_qi8 timing at M={m} K={k} N={n}: kernel "
              f"{row['ms']:.4f} ms, plain (float64) {row['plain_ms']:.4f} "
              f"ms, torch._int_mm "
              f"{'%.4f ms' % lib_ms if lib_ms is not None else 'null'}"
              f"{' (' + row['library_null_reason'] + ')' if lib_why else ''}"
              f", bound {bound_ms:.5f} ms ({bound_by})")
        shapes.append(row)
        if (m, k, n) == QI8_HEAD:
            record = {"name": "matmul_qi8", "route": "cuda",
                      "source": "src/repro_torch/kernels/csrc/matmul_qi8.cu",
                      "replaces": "src/repro/kernels/matmul_qi8.py:44",
                      **{key: row[key] for key in (
                          "max_abs_err", "ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms")}}
            if lib_why:
                record["library_null_reason"] = row["library_null_reason"]
    record["max_abs_err"] = max(r["max_abs_err"] for r in shapes)
    record["shapes"] = shapes
    return record


def check_cnn_zoo():
    """Every Table-1 model and synthetic_cnn(64) at its published input
    size, batch 1: graph totals against the model's own and the paper's
    Table 1 (the reference's bounds), the initialized tensors against the
    params count, and one fp32 forward on the card against the same port
    weights on the CPU within CNN_TOL of max |y| (TF32 off; cuDNN's and the
    CPU's convolutions sum in other orders).  Kernel launches must stay 0:
    the CNN forward runs cuDNN, as the reference runs XLA."""
    exempt = {"NASNetMobile", "ResNet50V2", "ResNet101V2", "ResNet152V2"}
    cpu = torch.device("cpu")
    worst = 0.0
    _build.reset_launches()
    for name in list(cnn.REAL_CNNS) + ["synthetic_cnn(64)"]:
        m = (cnn.synthetic_cnn(64) if name.startswith("synthetic")
             else cnn.REAL_CNNS[name]())
        g = m.to_layer_graph()
        params = m.init(cpu, torch.Generator(cpu).manual_seed(0))
        n_init = sum(t.numel() for p in params.values() for t in p.values())
        ok = (g.total_params == m.total_params == n_init
              and g.total_macs == m.total_macs)
        if name in cnn.TABLE1:
            p_m, macs_m = cnn.TABLE1[name]
            ok &= abs(m.total_params / 1e6 - p_m) / p_m < 0.08
            ok &= (name in exempt
                   or abs(m.total_macs / 1e6 - macs_m) / macs_m < 0.12)
        x = torch.randn((1,) + m.input_shape,
                        generator=torch.Generator(cpu).manual_seed(1))
        y_cpu = m.apply(params, x)
        t0 = time.perf_counter()
        y = m.apply(to_card(params), x.cuda())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        scale = y_cpu.abs().max().item()
        rel = (y.cpu() - y_cpu).abs().max().item() / scale
        worst = max(worst, rel)
        print(f"cnn {name} {m.input_shape}: {m.total_params} params, "
              f"{m.total_macs} MACs, depth {g.depth}; card vs CPU max_abs_err "
              f"/ max|y| {rel:.3e} (tol {CNN_TOL:g}; max|y| {scale:.3e}), "
              f"out {tuple(y.shape)}, first card forward {dt * 1e3:.1f} ms")
        if not (ok and rel <= CNN_TOL and bool(torch.isfinite(y).all())):
            raise SystemExit(f"cnn {name}: totals {ok}, card vs CPU {rel:.3e}"
                             f" (tol {CNN_TOL:g}) or not finite")
        del params, y, y_cpu
    check_counts("cnn zoo forwards", read_counts(), {})
    return worst


def stage_trace_times(trace, graph, pl):
    """Per stage of ``pl``: the trace's measured seconds of its depths."""
    depth = graph.depths()
    tmap = trace.depth_time_map()
    return [sum(tmap[d] for d in {depth[n] for n in layers})
            for layers in pl.stage_layers]


def serve_cnn(label, m, params, dep, reqs):
    """One unprofiled stream (req/s, latency, stage busy), then one under
    torch.profiler (device busy and idle share); the first served output
    must equal the direct forward on the card.  Returns the numbers."""
    outs, snap, seconds = serve.serve_stream(dep, reqs)
    lat, busy = snap["latency"], snap["stage_busy_s"]
    direct = m.apply(params, reqs[0][m.INPUT])
    err = (outs[0][m.output] - direct).abs().max().item()
    prof, wall = profile_serve.profiled(lambda: serve.serve_stream(dep, reqs))
    summ = profile_serve.summarize(prof, wall, f"{label} serve "
                                               f"1+{len(reqs)}", top=5)
    idle = 1 - summ["busy_s"] / summ["wall_s"]
    print(f"{label}: {len(reqs)} requests in {seconds * 1e3:.2f} ms, "
          f"{snap['throughput_rps']:.2f} req/s; latency p50/p95 "
          f"{lat['p50_s'] * 1e3:.3f} / {lat['p95_s'] * 1e3:.3f} ms "
          f"(n={lat['n']}); stage busy (s) {[round(b, 5) for b in busy]}, "
          f"balance (mean/max) {stage_balance_metrics(busy)['balance']:.3f};"
          f" device idle share {idle:.3f} (profiled stream); served vs "
          f"direct max_abs_err {err:.3e} (must be 0)")
    if not (err == 0 and snap["failed"] == 0 and lat["n"] == len(reqs)
            and all(o[m.output].shape == (1, 1000) for o in outs)):
        raise SystemExit(f"{label}: served output differs from the direct "
                         f"forward by {err:.3e} or requests failed")
    return {"rps": snap["throughput_rps"], "p50_ms": lat["p50_s"] * 1e3,
            "p95_ms": lat["p95_s"] * 1e3, "n": lat["n"],
            "stage_busy_s": busy, "idle_share": idle,
            "served_vs_direct": err}


def run_cnn_path():
    """The paper's path on the card: ResNet50 planned by the analytic Edge
    TPU model (balanced, 4 stages, paper Table 5), served through
    cnn_stage_fns; its per-depth profile captured on the card and the
    trace-source balanced_cost plan served the same way, once planned for
    the reference's Edge TPU (8 MiB a stage: its memory refinement
    decides the cuts) and once for a quarter of the card's memory a stage
    (the decode path's planning device), the plans served in turn
    CNN_ROUNDS times.  Returns every plan's numbers, and the model, its
    weights, the requests and the trace for the phases after it."""
    m = cnn.REAL_CNNS[CNN]()
    graph = m.to_layer_graph()
    dev = torch.device("cuda")
    params = m.init(dev, torch.Generator(dev).manual_seed(0))
    reqs = serve.cnn_requests(m, CNN_REQUESTS, dev, seed=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        m.apply(params, reqs[0][m.INPUT])
    torch.cuda.synchronize()
    direct_ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"{CNN} direct forward (batch 1, fp32): {direct_ms:.3f} ms")

    t0 = time.perf_counter()
    trace = profile_model(m, warmup=2, repeats=5, device=dev)
    profile_s = time.perf_counter() - t0
    path = ROOT / "build" / "profile" / f"{CNN}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    trace.save(str(path))
    print(f"{CNN} profile on the card: {len(trace.samples)} depth levels in "
          f"{profile_s:.1f} s, sum of level times "
          f"{sum(s.time_s for s in trace.samples) * 1e3:.3f} ms; saved "
          f"{path.relative_to(ROOT)} ({trace.device})")
    card_stage = EdgeTPUSpec(onchip_bytes=torch.cuda.get_device_properties(
        0).total_memory // STAGES)
    traced = dict(model=f"cnn:{CNN}", stages=STAGES,
                  strategy="balanced_cost", cost_source=f"trace:{path}")
    deps = {
        "analytic": serve.deploy_cnn(m, params, DeploymentSpec(
            model=f"cnn:{CNN}", stages=STAGES, strategy="balanced"), dev),
        "trace": serve.deploy_cnn(m, params, DeploymentSpec(**traced), dev),
        "trace, card memory": serve.deploy_cnn(
            m, params, DeploymentSpec(**traced), dev, base_spec=card_stage),
    }
    out = {"direct_ms": direct_ms, "plans": {}}
    for label, dep in deps.items():
        pl = dep.plan
        measured = stage_trace_times(trace, graph, pl)
        print(f"{CNN} {label} plan: cuts {list(pl.cuts)}, layers per stage "
              f"{[len(ls) for ls in pl.stage_layers]}; trace-measured stage "
              f"ms {[round(t * 1e3, 4) for t in measured]}")
        print(f"{CNN} {label} report: {pl.report.describe()}")
        out["plans"][label] = {
            "cuts": list(pl.cuts), "trace_stage_ms": [t * 1e3 for t in
                                                      measured],
            "vs_trace_err_pct": (pl.report.stage_time_error_pct
                                 if pl.report.has_trace else None),
            "served": []}
    _build.reset_launches()
    for _ in range(CNN_ROUNDS):
        for label, dep in deps.items():
            out["plans"][label]["served"].append(serve_cnn(
                f"{CNN} {label} plan", m, params, dep, reqs))
    check_counts(f"{CNN} serving", read_counts(), {})
    return out, {"model": m, "params": params, "reqs": reqs, "trace": trace}


def run_int8_head():
    """The int8 API's path: ResNet50's classifier head (8 images' 2048
    pooled features x the 2048 x 1000 dense weights) through
    ``quant.quantized_dense``, with matmul_qi8's count set to 0 just before
    and read just after (1 launch); bit-equal to the same call on the CPU,
    and within the int8 quantization error of the fp32 head."""
    m = cnn.REAL_CNNS[CNN]()
    dev = torch.device("cuda")
    params = m.init(dev, torch.Generator(dev).manual_seed(0))
    feats = m.apply_subset(params, {m.INPUT: torch.randn(
        (QI8_HEAD[0],) + m.input_shape, device=dev,
        generator=torch.Generator(dev).manual_seed(2))},
        [n for n in m.nodes if n != m.output])
    x = next(iter(feats.values()))
    w = params[m.output]["w"]
    _build.reset_launches()
    y = quant.quantized_dense(x, w)
    torch.cuda.synchronize()
    counts = read_counts()
    y_cpu = quant.quantized_dense(x.cpu(), w.cpu())
    fp32 = x @ w
    rel = ((y - fp32).abs().max() / fp32.abs().max()).item()
    print(f"int8 head {tuple(x.shape)} x {tuple(w.shape)}: quantized_dense "
          f"card = CPU bit for bit: {torch.equal(y.cpu(), y_cpu)}; vs the "
          f"fp32 head max_abs_err / max|y| {rel:.3e} (int8 quantization)")
    check_counts("int8 head", counts, {"matmul_qi8": 1})
    if not (torch.equal(y.cpu(), y_cpu) and rel < 0.05):
        raise SystemExit(f"int8 head: card != CPU or {rel:.3e} off fp32")
    return counts["matmul_qi8"]


def exit_misordered(reqs):
    """Adjacent inversions in the order the requests that completed on
    their first admission left the pipeline (their completion times):
    the order-restoring merge keeps submission order across failover and
    hot swaps.  A request re-admitted after a stage loss re-enters the
    stream at its tail by design, so it is left out."""
    done = sorted((r.t_done, i) for i, r in enumerate(reqs)
                  if r.event.is_set() and r.error is None and r.retries == 0)
    order = [i for _, i in done]
    return sum(1 for a, b in zip(order, order[1:]) if b < a)


def check_outputs(label, m, reqs, direct):
    """Every completed request's output equals the direct forward of its
    input, bit for bit (the same kernels on one card)."""
    errs = [(r.result[m.output] - d).abs().max().item()
            for r, d in zip(reqs, direct)
            if r.event.is_set() and r.error is None]
    worst = max(errs, default=0.0)
    print(f"{label}: {len(errs)} served outputs vs the direct forward, "
          f"max_abs_err {worst:.3e} (must be 0)")
    if worst != 0:
        raise SystemExit(f"{label}: served outputs differ from the direct "
                         f"forward by {worst:.3e}")


def replicated_plan(graph, budget):
    """The placement DP's cut over STAGES devices, the stages of largest
    modeled time given one more device each until ``budget`` devices are
    used: a 4-stage cut with replicated bottleneck stages."""
    base = plan(DeploymentSpec(strategy="placement", device_budget=STAGES),
                graph=graph)
    reps = [1] * base.n_stages
    slowest = sorted(range(base.n_stages),
                     key=lambda i: -base.stage_times_s[i])
    for i in slowest[:budget - base.n_devices]:
        reps[i] += 1
    return PlacementPlan.from_cuts(graph, base.cuts, strategy="replicated",
                                   replicas=reps)


def run_chaos_phase(m, params, reqs, dev, hedge_after_s,
                    interval_s=FT_INTERVAL_S, kill_at_s=FT_KILL_AT_S):
    """ResNet50 over a replicated 4-stage plan on FT_BUDGET devices, served
    with stage-loss retries, hedging and a HealthMonitor, while a
    ChaosMonkey (getter: the server's live executor) kills one replica of
    each replicated stage and then the last replica of the second: the
    monitor replans the survivors through ElasticPlanner and hot-swaps.
    The requests arrive every ``interval_s``.  Requires 3 kills applied,
    1 replan, 0 lost and 0 misordered, and every completed output equal
    to the direct forward."""
    graph = m.to_layer_graph()
    placed = plan(DeploymentSpec(strategy="placement",
                                 device_budget=FT_BUDGET), graph=graph)
    print(f"chaos: the placement DP over {FT_BUDGET} devices cuts "
          f"{graph.name} into {placed.n_stages} stages, replicas "
          f"{list(placed.replica_counts)}")
    pl0 = replicated_plan(graph, FT_BUDGET)
    spec = DeploymentSpec(model=f"cnn:{CNN}", strategy="placement",
                          device_budget=FT_BUDGET, stage_loss_retries=2,
                          hedge_after=hedge_after_s)

    def builder(p):
        return serve.cnn_stage_fns(m, params, p, dev)

    dep = Deployment.from_plan(pl0, spec, graph=graph,
                               stage_fn_builder=builder)
    a, b = [i for i, k in enumerate(pl0.replica_counts) if k > 1][:2]
    events = [ChaosEvent(kill_at_s[0], "kill_replica", a, 1),
              ChaosEvent(kill_at_s[1], "kill_replica", b, 1),
              ChaosEvent(kill_at_s[2], "kill_replica", b, 0)]
    direct = [m.apply(params, r[m.INPUT]) for r in reqs]
    _build.reset_launches()
    with dep.serve() as server:
        server.serve_batch(reqs[:1])            # warm-up
        server.start()
        server.snapshot()
        mon = HealthMonitor(server, ElasticPlanner(graph, spec=spec),
                            builder, policy=FaultPolicy(
                                heartbeat_timeout_s=FT_HEARTBEAT_S,
                                poll_interval_s=0.01)).start()
        monkey = ChaosMonkey(lambda: server.executor, events).start()
        t0 = time.perf_counter()
        pending = []
        for i, r in enumerate(reqs):
            pending.append(server.submit(r))
            time.sleep(max(0.0, t0 + (i + 1) * interval_s
                           - time.perf_counter()))
        lost = sum(1 for r in pending if not r.event.wait(120))
        seconds = time.perf_counter() - t0
        snap = server.snapshot()
        health = server.executor.health_snapshot()
        monkey.join(timeout=10)
        mon.stop()
        pl1 = server.plan
    counts = read_counts()
    failed = sum(1 for r in pending if r.event.is_set() and r.error)
    completed = sum(1 for r in pending if r.event.is_set() and not r.error)
    retried = sum(1 for r in pending if r.retries)
    misordered = exit_misordered(pending)
    lat = snap["latency"]
    kills = [(ev.kind, ev.stage, ev.slot, ok) for ev, ok in monkey.applied]
    print(f"chaos plan before: {pl0.describe()}")
    print(f"chaos plan after: {pl1.describe()}")
    print(f"chaos: kills applied {kills}; replans {mon.replans}; "
          f"monitor kills {mon.kills}")
    print(f"chaos: {len(reqs)} requests every {interval_s * 1e3:.0f} ms in "
          f"{seconds * 1e3:.1f} ms: completed {completed}, failed {failed}, "
          f"lost {lost}, misordered {misordered}, retried {retried}; "
          f"p50/p95 {lat['p50_s'] * 1e3:.3f} / {lat['p95_s'] * 1e3:.3f} ms "
          f"(n={lat['n']}); the final executor's hedges {health['hedges']} "
          f"after {hedge_after_s * 1e3:.2f} ms and re-dispatches "
          f"{health['redispatches']}")
    check_outputs("chaos", m, pending, direct)
    check_counts("chaos serving", counts, {})
    if not (sum(ok for *_, ok in kills) == 3 and len(mon.replans) == 1
            and lost == 0 and misordered == 0
            and completed + failed == len(reqs)):
        raise SystemExit(f"chaos: kills {kills}, replans {mon.replans}, "
                         f"lost {lost}, misordered {misordered}")
    return {"plan_before": {"cuts": list(pl0.cuts),
                            "replicas": list(pl0.replica_counts)},
            "plan_after": {"cuts": list(pl1.cuts),
                           "replicas": list(pl1.replica_counts)},
            "kills": kills, "replans": mon.replans,
            "completed": completed, "failed": failed, "lost": lost,
            "misordered": misordered, "retried": retried,
            "p50_ms": lat["p50_s"] * 1e3, "p95_ms": lat["p95_s"] * 1e3,
            "n": lat["n"], "seconds": seconds, "hedges": health["hedges"],
            "hedge_after_ms": hedge_after_s * 1e3,
            "redispatches": health["redispatches"]}


def run_ft_prefill(arch, hedge_after_ms, argv=()):
    """Full-width qwen3-1.7b prefill through ``serve.run`` over the
    placement plan of FT_BUDGET devices with stage-loss retries, hedging
    after ``hedge_after_ms`` and a deadline no request should reach.  The
    first output must be within 2e-2 of the direct forward, and
    flash_attention's launches must equal layers x forwards plus, for each
    hedged duplicate the executor reports, its stage's layers."""
    args = serve.parse_args(
        ["--arch", arch, "--device-budget", str(FT_BUDGET),
         "--stage-loss-retries", "1", "--hedge-after-ms",
         f"{hedge_after_ms}", "--deadline-ms", f"{FT_DEADLINE_MS}",
         "--requests", str(REQUESTS), "--seq", str(SEQ), *argv])
    _build.reset_launches()
    res = serve.run(args)
    counts = read_counts()
    cfg, pl, snap = res["cfg"], res["plan"], res["snapshot"]
    blocks = serve.stage_block_counts(pl, cfg.n_layers)
    hedges = snap["health"]["hedges"]
    forwards = args.requests + 2        # warm-up, requests, direct reference
    expect = cfg.n_layers * forwards + sum(h * n for h, n in zip(hedges,
                                                                 blocks))
    lat = snap["latency"]
    print(f"fault-tolerant prefill plan: {pl.describe()}; blocks per stage "
          f"{blocks}")
    print(f"fault-tolerant prefill: {len(res['outs'])} requests in "
          f"{res['seconds'] * 1e3:.2f} ms ({snap['throughput_rps']:.2f} "
          f"req/s); p50/p95 {lat['p50_s'] * 1e3:.2f} / "
          f"{lat['p95_s'] * 1e3:.2f} ms; hedges {hedges} after "
          f"{hedge_after_ms:.2f} ms; failed {snap['failed']}; pipeline vs "
          f"direct max err {res['max_err']:.2e}")
    print(f"fault-tolerant prefill flash_attention launches: "
          f"{counts['flash_attention']} = {cfg.n_layers} layers x "
          f"{forwards} forwards + hedged stage executions {hedges} x "
          f"blocks {blocks}")
    if not (res["max_err"] < 2e-2 and snap["failed"] == 0):
        raise SystemExit(f"fault-tolerant prefill: err {res['max_err']:.2e}"
                         f" or {snap['failed']} failed")
    check_counts("fault-tolerant prefill", counts,
                 {"flash_attention": expect})
    return {"plan": {"cuts": list(pl.cuts),
                     "replicas": list(pl.replica_counts)},
            "blocks": blocks, "hedges": hedges,
            "hedge_after_ms": hedge_after_ms, "max_err": res["max_err"],
            "rps": snap["throughput_rps"], "p50_ms": lat["p50_s"] * 1e3,
            "p95_ms": lat["p95_s"] * 1e3,
            "flash_attention": counts["flash_attention"]}


def stage_times_of(tmap, graph, pl):
    depth = graph.depths()
    return [sum(tmap.get(d, 0.0) for d in {depth[n] for n in layers})
            for layers in pl.stage_layers]


def err_pct(got, ref):
    """The plan report's ``vs trace`` form: mean over stages of
    |got - ref| / ref, in percent."""
    rel = [abs(g - r) / r for g, r in zip(got, ref) if r > 0]
    return sum(rel) / len(rel) * 100 if rel else -1.0


def run_selfheal_phase(m, params, trace, dev, batches=HEAL_BATCHES,
                       batch=HEAL_BATCH):
    """ResNet50 over the analytic balanced STAGES-stage plan under
    ``dep.self_heal(canaries)``, its windows driven by ``tick()`` after
    each batch of the stream (deterministic in windows).  Prints each
    window (req/s, per-item stage busy, drift, state), the controller's
    windows, commits, rollbacks, state and events, both plans, and the
    live trace's per-stage times beside the card trace's.  Every served
    output must equal the direct forward."""
    graph = m.to_layer_graph()
    spec = DeploymentSpec(model=f"cnn:{CNN}", stages=STAGES,
                          strategy="balanced", drift_threshold=HEAL_DRIFT,
                          canary_requests=HEAL_CANARIES)
    dep = serve.deploy_cnn(m, params, spec, dev)
    reqs = serve.cnn_requests(m, batches * batch, dev, seed=2)
    canaries = serve.cnn_requests(m, HEAL_CANARIES, dev, seed=3)
    direct = [m.apply(params, r[m.INPUT]) for r in reqs]
    pl0 = dep.plan
    windows = []
    _build.reset_launches()
    with dep.serve() as server:
        server.serve_batch(reqs[:1])            # warm-up
        server.start()
        server.snapshot()
        healer = dep.self_heal(canaries)        # no thread: tick() drives
        pending = []
        for k in range(batches):
            ex = server.executor
            busy0, items0 = ex.busy_snapshot(), ex.items_snapshot()
            t0 = time.perf_counter()
            part = [server.submit(r)
                    for r in reqs[k * batch:(k + 1) * batch]]
            if not all(r.event.wait(120) for r in part):
                raise SystemExit(f"self-heal: batch {k} timed out")
            wall = time.perf_counter() - t0
            busy = [b - a for a, b in zip(busy0, ex.busy_snapshot())]
            items = [b - a for a, b in zip(items0, ex.items_snapshot())]
            cuts = list(server.plan.cuts)
            drift = healer.tick()
            per_item = [bz / max(1, n) * 1e3 for bz, n in zip(busy, items)]
            windows.append({"cuts": cuts, "rps": batch / wall,
                            "stage_ms_per_item": per_item,
                            "bottleneck_ms": max(per_item),
                            "drift": drift, "state": healer.state})
            print(f"self-heal window {k}: cuts {cuts}, "
                  f"{batch / wall:.2f} req/s, per-item stage busy ms "
                  f"{[round(t, 4) for t in per_item]}, drift "
                  f"{'-' if drift is None else round(drift, 4)}, state "
                  f"{healer.state}")
            pending += part
        pl1 = server.plan
    counts = read_counts()
    check_outputs("self-heal", m, pending, direct)
    check_counts("self-heal serving", counts, {})
    if any(r.error is not None for r in pending):
        raise SystemExit("self-heal: requests failed")
    live = healer.trace.trace().depth_time_map()
    card = trace.depth_time_map()
    stages = {}
    for label, pl in (("before", pl0), ("after", pl1)):
        lv = stage_times_of(live, graph, pl)
        cd = stage_times_of(card, graph, pl)
        stages[label] = {"cuts": list(pl.cuts),
                         "live_stage_ms": [t * 1e3 for t in lv],
                         "card_trace_stage_ms": [t * 1e3 for t in cd],
                         "live_vs_card_trace_err_pct": err_pct(lv, cd)}
        print(f"self-heal plan {label}: {pl.describe()}; live-trace stage "
              f"ms {[round(t * 1e3, 4) for t in lv]} vs card-trace stage ms "
              f"{[round(t * 1e3, 4) for t in cd]} (live vs card trace: "
              f"{err_pct(lv, cd):.1f}% err)")
    first = next((i for i, w in enumerate(windows)
                  if w["cuts"] != windows[0]["cuts"]), len(windows))
    phases = {"before": windows[:first], "after": windows[first:]}
    summary = {}
    for label, ws in phases.items():
        if ws:
            summary[label] = {
                "windows": len(ws),
                "rps": sum(w["rps"] for w in ws) / len(ws),
                "bottleneck_ms": sum(w["bottleneck_ms"] for w in ws)
                / len(ws)}
    print(f"self-heal: {healer.windows} windows, {healer.commits} commits, "
          f"{healer.rollbacks} rollbacks (state={healer.state}); mean over "
          f"windows before / after the first commit: {summary}")
    print(f"self-heal events: {healer.events}")
    live_plan = measure_live_plan(m, params, dep, healer, reqs[:CNN_REQUESTS],
                                  direct, canaries, dev)
    return {"windows": healer.windows, "commits": healer.commits,
            "rollbacks": healer.rollbacks, "state": healer.state,
            "events": healer.events, "per_window": windows,
            "before_after": summary, "stages": stages,
            "live_plan": live_plan}


def measure_live_plan(m, params, dep, healer, reqs, direct, canaries, dev):
    """The plan the controller derives from the live trace (its replan,
    redone: the spec's stage count, the time-balancing replan strategy,
    the live trace as the cost source), measured apart from the canary's
    verdict: its canary per-item stage busy cold (a fresh executor, as the
    controller runs it) and warm (the same executor again), and the stream
    served over the incumbent and over it in turns (incumbent, live, live,
    incumbent), every output equal to the direct forward."""
    graph = dep.graph
    shaped = dataclasses.replace(
        dep.spec.with_stages(dep.plan.n_devices),
        strategy=healer.policy.replan_strategy, objective=None)
    cand = plan(shaped, graph=graph,
                cost_source=healer.trace.cost_source("trace"),
                attach_report=False)

    def builder(p):
        return serve.cnn_stage_fns(m, params, p, dev)

    with PipelineExecutor.for_plan(cand, builder(cand),
                                   name_prefix="canary") as ex:
        _, cold = ex.run_batch(canaries, collect_stage_times=True)
        _, warm = ex.run_batch(canaries, collect_stage_times=True)
    cold = [b / len(canaries) * 1e3 for b in cold]
    warm = [b / len(canaries) * 1e3 for b in warm]
    print(f"live-trace plan: {cand.describe()}; canary per-item stage busy "
          f"ms cold {[round(t, 4) for t in cold]}, warm "
          f"{[round(t, 4) for t in warm]}")
    deps = {"incumbent": dep,
            "live": Deployment.from_plan(cand, dep.spec, graph=graph,
                                         stage_fn_builder=builder)}
    served = {"incumbent": [], "live": []}
    for label in ("incumbent", "live", "live", "incumbent"):
        outs, snap, seconds = serve.serve_stream(deps[label], reqs)
        err = max((o[m.output] - d).abs().max().item()
                  for o, d in zip(outs, direct))
        busy = snap["stage_busy_s"]
        served[label].append({"rps": snap["throughput_rps"],
                              "stage_busy_s": busy,
                              "p50_ms": snap["latency"]["p50_s"] * 1e3,
                              "p95_ms": snap["latency"]["p95_s"] * 1e3})
        print(f"self-heal {label} plan served: {len(reqs)} requests, "
              f"{snap['throughput_rps']:.2f} req/s, stage busy (s) "
              f"{[round(b, 5) for b in busy]}, balance (mean/max) "
              f"{stage_balance_metrics(busy)['balance']:.3f}; served vs "
              f"direct max_abs_err {err:.3e} (must be 0)")
        if err != 0:
            raise SystemExit(f"self-heal {label} plan: served outputs "
                             f"differ from the direct forward by {err:.3e}")
    return {"cuts": list(cand.cuts), "canary_cold_ms": cold,
            "canary_warm_ms": warm, "served": served}


def run_fleet_phase(members, dev, windows=FLEET_WINDOWS):
    """A FleetSpec of the members (name, model ref, model, weights, share,
    p95 SLO ms) over FT_BUDGET devices, each served by ``cnn_stage_fns``: share-
    proportional traffic for ``windows`` windows, then the first member's
    load tripled, the autoscaler ticked after every window (as
    ``serve.run_fleet``).  Prints the pool split before and after, the
    autoscaler's events, attainment and the audit; requires 0 lost and 0
    misordered and every output equal to its member's direct forward."""
    fspec = FleetSpec(members=tuple(
        FleetMemberSpec(name, DeploymentSpec(model=ref, strategy="balanced",
                                             slo_p95_ms=slo), share=share)
        for name, ref, _, _, share, slo in members), device_budget=FT_BUDGET)
    models = {name: (model, params) for name, _, model, params, *_ in members}
    pools, direct = {}, {}
    for name, (model, params) in models.items():
        pools[name] = serve.cnn_requests(model, FLEET_POOL, dev, seed=4)
        direct[name] = [model.apply(params, r[model.INPUT])
                        for r in pools[name]]
    _build.reset_launches()
    fleet = deploy_fleet(
        fspec, graphs={n: mp[0].to_layer_graph() for n, mp in models.items()},
        stage_fn_builders={
            n: (lambda p, mp=mp: serve.cnn_stage_fns(mp[0], mp[1], p, dev))
            for n, mp in models.items()})
    counts0 = fleet.device_counts()
    for name, dep in fleet.deployments.items():
        print(f"fleet member {name}: {dep.plan.describe()}")
    print(f"fleet pool split: {counts0} (mode={fleet.placement.mode}, "
          f"worst modeled norm {fleet.placement.worst_norm:.3f})")
    base = {m.name: max(1, round(2 * m.share)) for m in fspec.members}
    shifted = dict(base)
    first = fspec.members[0].name
    shifted[first] = 3 * base[first]
    stats = {n: {"submitted": 0, "completed": 0, "failed": 0, "lost": 0,
                 "within_slo": 0, "lat": [], "exit": [], "err": 0.0}
             for n in models}
    lock = threading.Lock()

    def tap(name, i):
        def on_done(req):
            if req.error is None:
                with lock:
                    stats[name]["exit"].append(i)
        return on_done

    with fleet:
        for n in models:                        # warm-up, not counted
            req = fleet.submit(n, pools[n][0])
            if not req.event.wait(120) or req.error is not None:
                raise SystemExit(f"fleet: warm-up of {n} failed")
        for rates in (base, shifted):
            for _ in range(windows):
                window = []
                for name, rate in rates.items():
                    for _ in range(rate):
                        st = stats[name]
                        i = st["submitted"]
                        st["submitted"] += 1
                        window.append((name, i, fleet.submit(
                            name, pools[name][i % FLEET_POOL],
                            on_done=tap(name, i))))
                for name, i, req in window:
                    st = stats[name]
                    if not req.event.wait(120):
                        st["lost"] += 1
                        continue
                    if req.error is not None:
                        st["failed"] += 1
                        continue
                    model = models[name][0]
                    st["completed"] += 1
                    st["err"] = max(st["err"], (
                        req.result[model.output]
                        - direct[name][i % FLEET_POOL]).abs().max().item())
                    lat = req.t_done - req.t_submit
                    st["lat"].append(lat)
                    slo = fspec.member(name).spec.slo_p95_ms
                    st["within_slo"] += lat <= slo / 1e3
                if fleet.autoscaler is not None:
                    fleet.autoscaler.tick()
        counts1 = fleet.device_counts()
        events = ([] if fleet.autoscaler is None
                  else list(fleet.autoscaler.events))
    counts = read_counts()
    audit = {}
    for name, st in stats.items():
        lat = sorted(st["lat"])
        ex = st["exit"]
        audit[name] = {
            "submitted": st["submitted"], "completed": st["completed"],
            "failed": st["failed"], "lost": st["lost"],
            "misordered": sum(1 for a, b in zip(ex, ex[1:]) if b < a),
            "attainment": st["within_slo"] / max(1, st["submitted"]),
            "p50_ms": lat[len(lat) // 2] * 1e3 if lat else 0.0,
            "p95_ms": (lat[min(len(lat) - 1, int(0.95 * len(lat)))] * 1e3
                       if lat else 0.0),
            "served_vs_direct": st["err"]}
    print(f"fleet pool split {counts0} -> {counts1}; autoscaler events "
          f"{events}")
    print(f"fleet audit: {audit}")
    check_counts("fleet serving", counts, {})
    if not all(a["lost"] == 0 and a["misordered"] == 0
               and a["served_vs_direct"] == 0 for a in audit.values()):
        raise SystemExit(f"fleet: lost, misordered or wrong outputs: "
                         f"{audit}")
    return {"split_before": counts0, "split_after": counts1,
            "events": events, "audit": audit}


def to_card(tree):
    if isinstance(tree, dict):
        return {k: to_card(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_card(v) for v in tree]
    return tree.to("cuda")


def greedy_decode(cfg, params, prompts, n_new, max_len, token_by_token):
    """Greedy decode through ``api.decode`` on the card: ``prompts`` (B, P)
    prefilled into the cache in one call (or fed token by token), then
    ``n_new`` tokens.  Returns (tokens (B, n_new) on the CPU, decode calls,
    prefill seconds, seconds per generated token after the first), on the
    host clock with the card synchronized."""
    dev = torch.device("cuda")
    cache = api.init_cache(cfg, prompts.shape[0], max_len, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = [prompts[:, i:i + 1] for i in range(prompts.shape[1])] \
        if token_by_token else [prompts]
    for tok in steps:
        logits, cache = api.decode(cfg, params, tok.to(dev), cache)
    toks = [logits[:, -1].argmax(-1, keepdim=True)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    while len(toks) < n_new:
        logits, cache = api.decode(cfg, params, toks[-1], cache)
        toks.append(logits[:, -1].argmax(-1, keepdim=True))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (torch.cat(toks, 1).cpu(), len(steps) + n_new - 1, t1 - t0,
            (t2 - t1) / max(1, n_new - 1))


def check_family_on_card(arch, seq, prompt_len, n_new, max_len,
                         token_by_token):
    """The arch's smoke config (fp32) on the card against the same weights
    on the CPU, where the kernels' plain versions run: the forward of a
    (2, seq) batch, and a greedy decode loop of 2 rows through the KV cache
    or the recurrent state; logits at every step within 1e-4 (summation
    order over a few layers) and equal greedy tokens."""
    cfg = configs.get(arch).smoke_config()
    cpu = torch.device("cpu")
    params = api.init(cfg, cpu, torch.Generator(cpu).manual_seed(0))
    card = to_card(params)
    batch = concrete_batch(cfg, seq, 2, kind="prefill")
    err = (api.forward(cfg, card, batch).cpu()
           - api.forward(cfg, params, batch)).abs().max().item()
    prompt = concrete_batch(cfg, prompt_len, 2, kind="prefill")["tokens"]
    runs = []
    for dev, p in ((cpu, params), (torch.device("cuda"), card)):
        cache = api.init_cache(cfg, 2, max_len, dev)
        steps = ([prompt[:, i:i + 1] for i in range(prompt_len)]
                 if token_by_token else [prompt])
        seen, toks = [], []
        for i in range(len(steps) + n_new):
            tok = steps[i] if i < len(steps) else toks[-1]
            logits, cache = api.decode(cfg, p, tok.to(dev), cache)
            seen.append(logits[:, -1:].cpu())
            toks.append(logits[:, -1].argmax(-1, keepdim=True).cpu())
        runs.append((torch.cat(seen, 1), torch.cat(toks, 1)))
    dec_err = (runs[0][0] - runs[1][0]).abs().max().item()
    same = torch.equal(runs[0][1], runs[1][1])
    print(f"{arch} smoke, card vs CPU (plain versions): forward max_abs_err "
          f"{err:.3e}, decode loop ({'token by token' if token_by_token else 'prefilled'} "
          f"{prompt_len}-token prompt + {n_new} steps, max_len {max_len}) "
          f"max_abs_err {dec_err:.3e} (tol 1e-4), greedy tokens equal={same}")
    if not (err <= 1e-4 and dec_err <= 1e-4 and same
            and torch.isfinite(runs[1][0]).all()):
        raise SystemExit(f"{arch} on the card disagrees with the CPU: "
                         f"{err}, {dec_err}, tokens equal={same}")


def read_counts():
    return {name: _build.launches(name) for name in KERNELS}


def check_counts(label, counts, expect):
    """Every kernel's launches in a run equal ``expect`` (absent: 0)."""
    want = {name: expect.get(name, 0) for name in counts}
    print(f"{label} launches: {counts} (expected {want})")
    if counts != want:
        raise SystemExit(f"{label}: kernel launches {counts} != {want}")


def print_plan(cfg):
    """The arch's 4-stage balanced plan over its full-width graph."""
    pl = plan(DeploymentSpec(stages=STAGES, strategy="balanced"),
              graph=lm_graph.lm_layer_graph(cfg, seq_len=SEQ))
    print(f"{cfg.name} plan:", pl.describe())
    print(f"{cfg.name} report:", pl.report.describe())


def teacher_rows(cfg, params, prompts, outs):
    """Logits of the full forward of prompt + served tokens at the
    positions that predicted each served token: (B, n, V)."""
    seq = torch.cat([prompts, outs], 1)
    logits = api.forward(cfg, params, {"tokens": seq})
    p = prompts.shape[1]
    return logits[:, p - 1:p - 1 + outs.shape[1]]


def teacher_forced(cfg, params, prompts, outs, n_new, max_len,
                   token_by_token):
    """The served bf16 tokens against the full forward of prompt + tokens
    (the method of :func:`check_served_tokens`): each served token's gap to its position's largest
    logit within twice the bf16 forward's largest deviation from the fp32
    evaluation of the same weights.  At least TEACHER_AGREE of the served
    tokens must be the teacher's argmax at the positions where bf16 can
    resolve the argmax: the teacher's top-2 margin exceeds twice that
    position's largest bf16-vs-fp32 deviation (elsewhere two bf16
    evaluations may rank a near-tie either way; the gap bound still holds
    there), and there must be at least TEACHER_MIN_DECISIVE such
    positions.  Then the same decode loop in fp32 at full width: every token
    within TEACHER_TOL of its fp32 teacher's largest logit."""
    cfg32, p32 = dataclasses.replace(cfg, dtype=torch.float32), \
        to_fp32(params)
    rows = teacher_rows(cfg, params, prompts, outs)
    rows32 = teacher_rows(cfg32, p32, prompts, outs)
    dev = (rows - rows32).abs().amax(-1)                # per position
    noise = dev.max().item()
    tk = outs.to(rows.device)[..., None]
    worst = (rows.max(-1).values - rows.gather(-1, tk)[..., 0]).max().item()
    top2 = rows.topk(2, dim=-1).values
    decisive = ((top2[..., 0] - top2[..., 1]) > 2 * dev).cpu()
    hit = rows.argmax(-1).cpu() == outs
    agree, total = int(hit.sum()), outs.numel()
    agree_dec, n_dec = int(hit[decisive].sum()), int(decisive.sum())
    print(f"{cfg.name} teacher-forced (bf16): largest gap {worst:.4e} "
          f"(bound 2 x {noise:.4e}, the bf16 forward's largest deviation "
          f"from fp32 on these positions; {TEACHER_TOL:g} "
          f"{'met' if worst <= TEACHER_TOL else 'not met'}); served token "
          f"= teacher argmax {agree}/{total} overall, {agree_dec}/{n_dec} "
          f"where the top-2 margin exceeds twice the position's deviation "
          f"(at least {TEACHER_MIN_DECISIVE} such positions required)")
    if not (worst <= 2 * noise and n_dec >= TEACHER_MIN_DECISIVE
            and agree_dec >= TEACHER_AGREE * n_dec):
        raise SystemExit(f"{cfg.name}: served tokens fail the teacher-forced "
                         f"check: gap {worst:.3e} > {2 * noise:.3e} or "
                         f"argmax agreement {agree_dec}/{n_dec} (fewer than "
                         f"{TEACHER_MIN_DECISIVE} decisive positions, or "
                         f"below {TEACHER_AGREE:.0%})")
    del rows, rows32
    outs32, _, _, _ = greedy_decode(cfg32, p32, prompts, n_new, max_len,
                                    token_by_token)
    rows32 = teacher_rows(cfg32, p32, prompts, outs32)
    tk = outs32.to(rows32.device)[..., None]
    worst32 = (rows32.max(-1).values
               - rows32.gather(-1, tk)[..., 0]).max().item()
    print(f"{cfg.name} decode loop in fp32 at full width: largest "
          f"teacher-forced gap {worst32:.4e} over {outs32.numel()} tokens "
          f"(tol {TEACHER_TOL:g}); fp32 tokens = bf16 tokens "
          f"{int((outs32 == outs).sum())}/{total}")
    if not worst32 <= TEACHER_TOL:
        raise SystemExit(f"{cfg.name}: fp32 decode loop fails the "
                         f"teacher-forced check: {worst32:.3e}")


def run_rwkv6_path():
    """rwkv6-1.6b at full width: plan, then 4 x 1024-token prompts
    prefilled into the state and 64 greedy tokens each through the model
    API, launch counts, teacher forcing.  Returns the rwkv6_scan count."""
    cfg = configs.get(RWKV_ARCH).config()
    print_plan(cfg)
    params = api.init(cfg, "cuda", torch.Generator("cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (RWKV_STREAMS, RWKV_PROMPT), dtype=np.int64))
    _build.reset_launches()
    outs, calls, prefill_s, step_s = greedy_decode(
        cfg, params, prompts, RWKV_NEW, RWKV_PROMPT + RWKV_NEW, False)
    counts = read_counts()
    print(f"{cfg.name}: prefill of {RWKV_STREAMS} x {RWKV_PROMPT} tokens "
          f"into the state {prefill_s * 1e3:.3f} ms, then {RWKV_NEW} tokens "
          f"each at {step_s * 1e3:.3f} ms a step ({RWKV_STREAMS} rows); "
          f"{calls} decode calls")
    check_counts(cfg.name, counts, {"rwkv6_scan": cfg.n_layers * calls})
    teacher_forced(cfg, params, prompts, outs, RWKV_NEW,
                   RWKV_PROMPT + RWKV_NEW, False)
    return counts["rwkv6_scan"]


def run_gemma_path():
    """recurrentgemma-9b at full width: plan, one forward of a (2, 1024)
    batch, a decode loop of 16 rows (32-token prompt token by token + 32
    greedy tokens, max_len 64), launch counts, teacher forcing.  Returns
    the launch counts of the forward and of the decode loop."""
    cfg = configs.get(GEMMA_ARCH).config()
    print_plan(cfg)
    n_rec = cfg.n_layers - cfg.n_layers // cfg.attn_every
    n_attn = cfg.n_layers // cfg.attn_every
    params = api.init(cfg, "cuda", torch.Generator("cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, GEMMA_FORWARD, dtype=np.int64))}
    _build.reset_launches()
    logits = api.forward(cfg, params, batch, last_token_only=True)
    torch.cuda.synchronize()
    fwd_counts = read_counts()
    check_counts(f"{cfg.name} forward", fwd_counts,
                 {"rglru_scan": n_rec, "flash_attention": n_attn})
    if not (logits.shape == (GEMMA_FORWARD[0], 1, cfg.vocab)
            and bool(torch.isfinite(logits).all())):
        raise SystemExit(f"{cfg.name}: forward logits not finite "
                         f"{tuple(logits.shape)}")
    t0 = time.perf_counter()
    for _ in range(3):
        api.forward(cfg, params, batch, last_token_only=True)
    torch.cuda.synchronize()
    print(f"{cfg.name}: forward of a {GEMMA_FORWARD} batch "
          f"{(time.perf_counter() - t0) / 3 * 1e3:.3f} ms (last token "
          f"logits finite)")

    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (GEMMA_ROWS, GEMMA_PROMPT), dtype=np.int64))
    _build.reset_launches()
    outs, calls, prefill_s, step_s = greedy_decode(
        cfg, params, prompts, GEMMA_NEW, GEMMA_MAX_LEN, True)
    dec_counts = read_counts()
    print(f"{cfg.name}: {GEMMA_PROMPT}-token prompt fed token by token in "
          f"{prefill_s * 1e3:.3f} ms, then {GEMMA_NEW} tokens at "
          f"{step_s * 1e3:.3f} ms a step ({GEMMA_ROWS} rows, max_len "
          f"{GEMMA_MAX_LEN}); {calls} decode calls")
    check_counts(f"{cfg.name} decode", dec_counts,
                 {"rglru_scan": n_rec * calls, "flash_decode": n_attn * calls})
    teacher_forced(cfg, params, prompts, outs, GEMMA_NEW, GEMMA_MAX_LEN, True)
    return fwd_counts, dec_counts


def run_decode_path():
    """The decode serving run with both kernels' counts set to 0 just
    before and read just after; checks counts, stream lengths and the
    teacher-forced correctness of the served tokens, then the same path
    in fp32.  Returns the flash_decode launch count."""
    per_stage = torch.cuda.get_device_properties(0).total_memory // STAGES
    args = serve.parse_args([
        "--arch", ARCH, "--workload", "decode", "--stages", str(STAGES),
        "--decode-concurrency", str(DECODE_SLOTS),
        "--max-context", str(DECODE_CONTEXT), "--prompt-len", str(SEQ),
        "--max-new-tokens", str(DECODE_NEW),
        "--requests", str(DECODE_STREAMS),
        "--plan-device-bytes", str(per_stage), "--device", "cuda"])
    _build.reset_launches()
    res = serve.run_decode(args)
    counts = read_counts()
    fa_launches, fd_launches = counts["flash_attention"], counts["flash_decode"]

    cfg, pl, snap, warm = (res["cfg"], res["plan"], res["snapshot"],
                           res["warmup"])
    rep = pl.report
    outs = res["outs"]
    print("decode plan:", pl.describe())
    print("decode blocks per stage:",
          serve.stage_block_counts(pl, cfg.n_layers))
    print(f"planning device: {per_stage} bytes per stage (card memory / "
          f"{STAGES}); stage_kv_bytes {list(rep.stage_kv_bytes)}, "
          f"kv_headroom_pct {rep.kv_headroom_pct:.3f}")
    steps = warm["steps"] + snap["steps"]
    prefills = warm["admitted"] + snap["admitted"]
    gaps = snap["tokens"] - len(outs)
    busy = res["stage_busy_s"]
    print(f"decode: {len(outs)} streams x {DECODE_NEW} tokens of "
          f"{SEQ}-token prompts in {res['seconds'] * 1e3:.2f} ms: "
          f"{snap['tokens'] / res['seconds']:.2f} tokens/s over the stream")
    print(f"decode inter-token p50/p95 (ms): "
          f"{snap['inter_token_p50_s'] * 1e3:.3f} / "
          f"{snap['inter_token_p95_s'] * 1e3:.3f} ({gaps} gaps)")
    print(f"decode steps: {snap['steps']} in the stream, {steps} with the "
          f"warm-up; prefills {prefills}")
    print(f"decode stage busy (s): {[round(b, 5) for b in busy]}, balance "
          f"(mean/max) {stage_balance_metrics(busy)['balance']:.3f}")
    print(f"decode modeled: {rep.decode_tokens_per_s:.2f} tokens/s, KV "
          f"headroom {rep.kv_headroom_pct:.3f}%")
    print(f"decode launches: flash_decode {fd_launches} ({cfg.n_layers} "
          f"layers x {steps} steps), flash_attention {fa_launches} "
          f"({cfg.n_layers} layers x {prefills} prefills)")

    if not all(len(o) == DECODE_NEW for o in outs):
        raise SystemExit(f"decode streams returned {[len(o) for o in outs]} "
                         f"tokens, expected {DECODE_NEW} each")
    if steps == 0:
        raise SystemExit("the decode run took no step")
    check_counts(f"{ARCH} decode serving", counts,
                 {"flash_decode": cfg.n_layers * steps,
                  "flash_attention": cfg.n_layers * prefills})

    check_served_tokens(res)
    check_fp32_decode_path(res)
    return fd_launches


def teacher_logits(cfg, params, prompt, toks):
    """Logits of the full forward of prompt + tokens (the prefill path,
    flash_attention) at the positions that predicted each token."""
    seq = torch.from_numpy(np.concatenate([prompt, toks]).astype(
        np.int64))[None]
    logits = api.forward(cfg, params, {"tokens": seq})[0]
    return logits[len(prompt) - 1:len(prompt) - 1 + len(toks)]


def token_gaps(rows, toks):
    """Per position: largest logit minus the logit of the given token."""
    tk = torch.as_tensor(toks, device=rows.device)
    return rows.max(-1).values - rows[torch.arange(len(toks)), tk]


def to_fp32(tree):
    if isinstance(tree, dict):
        return {k: to_fp32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_fp32(v) for v in tree]
    return tree.float()


def check_served_tokens(res):
    """Teacher forcing of the bf16 stream: the full forward of prompt +
    served tokens ranks each served token near its position's largest
    logit.  Two bf16 evaluations of the model (the batched decode steps
    and the 1088-token forward) differ by their rounding, so the bound is
    twice the bf16 forward's own largest deviation from the fp32
    evaluation of the same weights, measured here on the same positions;
    and at least TEACHER_AGREE of the served tokens must be the teacher's
    argmax."""
    cfg, params = res["cfg"], res["params"]
    cfg32, p32 = dataclasses.replace(cfg, dtype=torch.float32), \
        to_fp32(params)
    worst = noise = 0.0
    agree = total = 0
    for prompt, toks in zip(res["prompts"][:TEACHER_STREAMS],
                            res["outs"][:TEACHER_STREAMS]):
        rows = teacher_logits(cfg, params, prompt, toks)
        rows32 = teacher_logits(cfg32, p32, prompt, toks)
        noise = max(noise, (rows - rows32).abs().max().item())
        worst = max(worst, token_gaps(rows, toks).max().item())
        agree += int((rows.argmax(-1).cpu() == torch.as_tensor(toks)).sum())
        total += len(toks)
    print(f"decode teacher-forced (bf16): largest gap between a served "
          f"token's logit and its position's largest logit {worst:.4e} "
          f"(bound 2 x {noise:.4e}, the bf16 forward's largest deviation "
          f"from fp32 on these positions; {TEACHER_TOL:g} "
          f"{'met' if worst <= TEACHER_TOL else 'not met'}); served token "
          f"= teacher argmax {agree}/{total}")
    if not (worst <= 2 * noise and agree >= TEACHER_AGREE * total):
        raise SystemExit(f"served tokens fail the teacher-forced check: "
                         f"gap {worst:.3e} > {2 * noise:.3e} or argmax "
                         f"agreement {agree}/{total} < {TEACHER_AGREE:.0%}")


def check_fp32_decode_path(res, n_new=16):
    """The decode path at full width in fp32 (the served weights upcast,
    the same stage cuts, the flash_decode kernel's fp32 instantiation):
    two streams in slots 1 and 2 of 3 (slot 0 idle), each served token
    within TEACHER_TOL of its position's largest logit in the fp32
    teacher-forced forward."""
    cfg, params, pl = res["cfg"], res["params"], res["plan"]
    cfg32, p32 = dataclasses.replace(cfg, dtype=torch.float32), \
        to_fp32(params)
    prompts = res["prompts"][:2]
    eng = PipelineDecodeEngine(cfg32, p32, n_slots=3,
                               max_context=DECODE_CONTEXT,
                               stage_blocks=serve.stage_block_counts(
                                   pl, cfg.n_layers))
    with eng:
        outs = [[eng.prefill(1 + j, p)] for j, p in enumerate(prompts)]
        ctx = [len(p) + 1 for p in prompts]
        while len(outs[0]) < n_new:
            for o, t in zip(outs, eng.step([1, 2], ctx,
                                           [o[-1] for o in outs])):
                o.append(t)
            ctx = [c + 1 for c in ctx]
    worst = max(token_gaps(teacher_logits(cfg32, p32, p, o), o).max().item()
                for p, o in zip(prompts, outs))
    print(f"decode path in fp32 at full width: largest teacher-forced gap "
          f"{worst:.4e} over 2 streams x {n_new} tokens (tol "
          f"{TEACHER_TOL:g})")
    if not worst <= TEACHER_TOL:
        raise SystemExit(f"fp32 decode path fails the teacher-forced "
                         f"check: {worst:.3e} > {TEACHER_TOL:g}")


def device_line():
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


def kernel_times() -> int:
    """Build and time flash_decode, rwkv6_scan and rglru_scan of the
    imported tree at this script's timing points."""
    t0 = time.perf_counter()
    _build.build(TIMED)
    print(f"built {', '.join(TIMED)} from {TREE} in "
          f"{time.perf_counter() - t0:.1f} s")
    times = {"flash_decode": time_decode_points(),
             "rwkv6_scan": time_rwkv6_points(),
             "rglru_scan": time_rglru_points()}
    print(json.dumps({"kernel_times": times, "tree": str(TREE)}))
    print(device_line())
    return 0


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
    if "--kernel-times" in sys.argv:
        return kernel_times()

    t0 = time.perf_counter()
    libs = _build.build(KERNELS)
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "entry function" in line or "Used" in line or "spill" in line:
                print(f"  {name} ptxas: {line.strip()}")
    # the three latest redesigns must not spill
    for name in TIMED:
        log = libs[name].with_suffix(".log").read_text()
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill", log)]
        if not spills or max(spills) > 0:
            raise SystemExit(f"{name}: ptxas reports spills {spills}")
    # the tensor-core kernels: every bf16 flash_attention and
    # flash_decode and every matmul_qi8 instantiation holds mma.sync
    tensor_ops = {}
    for name, op, kernel in (("flash_attention", "HMMA", "bf16_kernel"),
                             ("flash_decode", "HMMA", "bf16_kernel"),
                             ("matmul_qi8", "IMMA", "matmul_qi8_kernel")):
        counts = tensor_core_ops(libs[name], op, kernel)
        print(f"{name} SASS: {op} per {kernel} instantiation "
              f"{sorted(counts.values())}")
        if not counts or min(counts.values()) == 0:
            raise SystemExit(f"{name}: a {kernel} without {op} (or none "
                             f"found): {counts}")
        tensor_ops[name] = {"op": op, "instantiations": len(counts),
                            "count": sum(counts.values())}

    record = check_flash_attention()
    record["windowed"] = check_windowed_flash_attention()
    decode_record = check_flash_decode()
    rwkv_record = check_rwkv6_scan()
    rglru_record = check_rglru_scan()
    qi8_record = check_matmul_qi8()
    torch.cuda.empty_cache()
    # max_len 300 puts qwen3's cache over two flash_decode splits
    check_family_on_card(ARCH, seq=200, prompt_len=40, n_new=8, max_len=300,
                         token_by_token=True)
    check_family_on_card(RWKV_ARCH, seq=200, prompt_len=40, n_new=8,
                         max_len=48, token_by_token=False)
    # max_len 24 over the smoke window 16: the ring cache wraps
    check_family_on_card(GEMMA_ARCH, seq=16, prompt_len=8, n_new=16,
                         max_len=24, token_by_token=True)

    args = serve.parse_args(["--arch", ARCH, "--stages", str(STAGES),
                             "--requests", str(REQUESTS), "--seq", str(SEQ),
                             "--strategy", "balanced", "--device", "cuda"])
    _build.reset_launches()
    res = serve.run(args)
    counts = read_counts()
    launches = counts["flash_attention"]
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
    check_counts(f"{ARCH} prefill serving", counts,
                 {"flash_attention": cfg.n_layers * forwards})

    # the fault-tolerant prefill phase hedges after a few bottleneck-stage
    # times of this stream
    ft_hedge_ms = FT_HEDGE_X * max(busy) / len(res["outs"]) * 1e3
    direct_ms = direct_forward_ms(cfg, res["params"], res["requests"][0])
    print(f"direct forward of one {SEQ}-token request: {direct_ms:.3f} ms; "
          f"{cfg.n_layers} flash_attention calls at {record['ms']:.4f} ms = "
          f"{cfg.n_layers * record['ms'] / direct_ms:.1%} of it")
    del res

    decode_record["launches"] = run_decode_path()
    torch.cuda.empty_cache()
    rwkv_record["launches"] = run_rwkv6_path()
    torch.cuda.empty_cache()
    fwd_counts, dec_counts = run_gemma_path()
    rglru_record["launches"] = (fwd_counts["rglru_scan"]
                                + dec_counts["rglru_scan"])
    # the flash kernels' launches on recurrentgemma's paths, beside the
    # qwen3 paths' counts above
    record["launches_recurrentgemma"] = fwd_counts["flash_attention"]
    decode_record["launches_recurrentgemma"] = dec_counts["flash_decode"]
    torch.cuda.empty_cache()

    zoo_worst = check_cnn_zoo()
    cnn_res, ctx = run_cnn_path()
    qi8_record["launches"] = run_int8_head()
    print(json.dumps({"cnn": {"zoo_worst_rel_err": zoo_worst, **cnn_res}}))

    # the fault-tolerance, self-healing and fleet tiers
    dev = torch.device("cuda")
    m, params = ctx["model"], ctx["params"]
    busy = cnn_res["plans"]["analytic"]["served"][0]["stage_busy_s"]
    ft = {"chaos": run_chaos_phase(m, params, ctx["reqs"], dev,
                                   FT_HEDGE_X * max(busy) / CNN_REQUESTS)}
    ft["prefill"] = run_ft_prefill(ARCH, ft_hedge_ms)
    record["launches_ft_prefill"] = ft["prefill"]["flash_attention"]
    torch.cuda.empty_cache()
    ft["self_heal"] = run_selfheal_phase(m, params, ctx["trace"], dev)
    members = []
    for name, model_name, share, slo in FLEET:
        fm = m if model_name == CNN else cnn.REAL_CNNS[model_name]()
        fp = (params if fm is m
              else fm.init(dev, torch.Generator(dev).manual_seed(0)))
        members.append((name, f"cnn:{model_name}", fm, fp, share, slo))
    ft["fleet"] = run_fleet_phase(members, dev)
    print(json.dumps({"ft": ft}, default=str))

    kernels = [record, decode_record, rwkv_record, rglru_record, qi8_record]
    for rec in kernels:
        rec["design"] = DESIGNS[rec["name"]]
        if rec["name"] in tensor_ops:
            rec["sass"] = tensor_ops[rec["name"]]
    print(json.dumps({"kernels": kernels}))
    print(device_line())
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
