#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel of the serving paths from the sources in this
   checkout (one nvcc per source, started together);
3. holds each kernel against its plain PyTorch version at the shapes the
   serving paths give it, and times kernel, plain version and one library
   call (the yardstick; the port never calls it);
4. holds the full model on the card against the same model on the CPU at
   the smoke config (the CPU runs the plain attention), for a prefill
   forward and for a greedy decode loop through the KV cache;
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
7. prints one JSON line of kernel results, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Any failed phase raises and exits non-zero.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs  # noqa: E402  (needs src/ on the path)
from repro_torch.configs.common import concrete_batch  # noqa: E402
from repro_torch.core.pipeline import stage_balance_metrics  # noqa: E402
from repro_torch.decode.engine import PipelineDecodeEngine  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels.ref import (flash_attention_ref,  # noqa: E402
                                     flash_decode_ref)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402

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
# per-slot lengths of the kernel check: empty, one, block edges, ragged,
# the path's range, full
DECODE_LENS = [0, 1, 127, 128, 1000, 1088, 2047, 2048]
# the timed point: every slot mid-stream of the decode run (1024-token
# prompts, 1 to 64 generated tokens)
DECODE_TIMED_LEN = 1056
COLD_SETS = 8           # distinct cache sets the kernel timing rotates over
BACKLOG_CYCLES = 100_000_000    # ~50 ms of device sleep while the host queues
# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
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
            ms = cuda_ms([lambda: fa.flash_attention(q, k, v, causal=True)])
            plain_ms = cuda_ms([lambda: flash_attention_ref(q, k, v, True)])
            library_ms = cuda_ms([
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)])
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


def check_flash_decode():
    """Kernel vs plain version at the decode path's widths (B 8, Hq 16,
    Hkv 8, D 128, T 2048) with per-slot lengths, plus fp32, MQA and D 16
    cases; rows of length 0 must be zeros.  Then times kernel, plain
    version and SDPA at the path's point, rotating over cache sets.
    Returns the kernel's record."""
    cases = [  # name, b, hq, hkv, t, d, dtype, model layout, lengths, tol
        ("bf16 B=8 T=2048, model layout, per-slot lengths", 8, 16, 8, 2048,
         128, torch.bfloat16, True, DECODE_LENS, 2e-2),
        ("fp32 B=8 T=2048, per-slot lengths", 8, 16, 8, 2048, 128,
         torch.float32, False, DECODE_LENS, 1e-5),
        ("fp32 MQA group 8, D=64 T=1000, per-slot lengths", 4, 8, 1, 1000,
         64, torch.float32, False, [1, 255, 999, 1000], 1e-5),
        ("bf16 D=16 T=300, model layout, scalar length 200", 2, 4, 2, 300,
         16, torch.bfloat16, True, 200, 2e-2),
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

    b, hq, hkv, t, d, dtype = 8, 16, 8, DECODE_CONTEXT, 128, torch.bfloat16
    lens = torch.full((b,), DECODE_TIMED_LEN, dtype=torch.int32,
                      device="cuda")
    sets = [decode_inputs(b, hq, hkv, t, d, dtype, True, seed=i)
            for i in range(COLD_SETS)]
    valid = (torch.arange(t, device="cuda")[None, :]
             < lens[:, None])[:, None, None, :]
    kernel = [lambda s=s: fd.flash_decode(*s, lens) for s in sets]
    ms = cuda_ms(kernel, reps=40)
    issued_ms = cuda_ms(kernel, reps=40, backlog=False)
    plain_ms = cuda_ms([lambda s=s: flash_decode_ref(*s, lens)
                        for s in sets], reps=40)
    library_ms = cuda_ms([
        lambda s=s: torch.nn.functional.scaled_dot_product_attention(
            s[0][:, :, None], s[1], s[2], attn_mask=valid, enable_gqa=True)
        for s in sets], reps=40)
    bound_ms, bound_by = decode_bound(sets[0][0], sets[0][1], lens)
    record.update({
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:62",
        "ms": ms, "kernel_ms": ms, "issued_ms": issued_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "shape": {"b": b, "hq": hq, "hkv": hkv, "t": t, "d": d,
                  "dtype": str(dtype), "lens": DECODE_TIMED_LEN,
                  "cache_sets": COLD_SETS}})
    print(f"flash_decode timing at B={b} T={t} len={DECODE_TIMED_LEN} "
          f"(bf16, model layout, {COLD_SETS} cache sets): kernel "
          f"{ms:.4f} ms ({issued_ms:.4f} ms a call as the host issues "
          f"them), plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    del sets
    torch.cuda.empty_cache()
    return record


def to_card(tree):
    if isinstance(tree, dict):
        return {k: to_card(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_card(v) for v in tree]
    return tree.to("cuda")


def check_model_on_card():
    """The smoke-config model (fp32) on the card against the same weights
    on the CPU, where attention is the plain version; tolerance 1e-4
    (summation order over four layers)."""
    cfg = configs.get(ARCH).smoke_config()
    cpu = torch.device("cpu")
    params = lm.init_params(cfg, cpu, torch.Generator(cpu).manual_seed(0))
    batch = concrete_batch(cfg, 200, 2, kind="prefill")
    got = lm.forward(cfg, to_card(params), batch).cpu()
    expect = lm.forward(cfg, params, batch)
    err = (got - expect).abs().max().item()
    print(f"smoke model, card vs CPU (plain attention): max_abs_err "
          f"{err:.3e} (tol 1e-4)")
    if not (torch.isfinite(got).all() and err <= 1e-4):
        raise SystemExit(f"model on the card disagrees with the CPU: {err}")


def check_decode_on_card(prompt_len=40, n_new=8, max_len=300):
    """The smoke config's greedy decode loop (fp32, batch 2, the prompt
    teacher-forced token by token through ``forward_decode``) on the card
    against the CPU, where attention is the plain version: logits within
    1e-4 at every step (summation order over four layers) and equal greedy
    tokens.  ``max_len`` 300 puts the cache over two kernel splits."""
    cfg = configs.get(ARCH).smoke_config()
    cpu = torch.device("cpu")
    params = lm.init_params(cfg, cpu, torch.Generator(cpu).manual_seed(0))
    prompt = concrete_batch(cfg, prompt_len, 2, kind="prefill")["tokens"]
    runs = []
    for dev, p in ((cpu, params), (torch.device("cuda"), to_card(params))):
        cache = lm.init_cache(cfg, 2, max_len, dev)
        logits_seen, toks = [], []
        for i in range(prompt_len + n_new):
            tok = prompt[:, i:i + 1] if i < prompt_len else toks[-1]
            logits, cache = lm.forward_decode(cfg, p, tok.to(dev), cache)
            logits_seen.append(logits.cpu())
            toks.append(logits[:, -1].argmax(-1, keepdim=True).cpu())
        runs.append((torch.cat(logits_seen, 1), torch.cat(toks, 1)))
    err = (runs[0][0] - runs[1][0]).abs().max().item()
    same = torch.equal(runs[0][1], runs[1][1])
    print(f"smoke decode loop, card vs CPU (plain attention): max_abs_err "
          f"{err:.3e} over {prompt_len + n_new} steps (tol 1e-4), greedy "
          f"tokens equal={same}")
    if not (torch.isfinite(runs[1][0]).all() and err <= 1e-4 and same):
        raise SystemExit(f"decode on the card disagrees with the CPU: "
                         f"{err}, tokens equal={same}")


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
    fa.reset_launches()
    fd.reset_launches()
    res = serve.run_decode(args)
    fa_launches, fd_launches = fa.launches, fd.launches

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
    if fd_launches != cfg.n_layers * steps or steps == 0:
        raise SystemExit(f"flash_decode launched {fd_launches} times, "
                         f"expected {cfg.n_layers} x {steps}")
    if fa_launches != cfg.n_layers * prefills:
        raise SystemExit(f"flash_attention launched {fa_launches} times in "
                         f"the decode run, expected {cfg.n_layers} x "
                         f"{prefills}")

    check_served_tokens(res)
    check_fp32_decode_path(res)
    return fd_launches


def teacher_logits(cfg, params, prompt, toks):
    """Logits of the full forward of prompt + tokens (the prefill path,
    flash_attention) at the positions that predicted each token."""
    seq = torch.from_numpy(np.concatenate([prompt, toks]).astype(
        np.int64))[None]
    logits = lm.forward(cfg, params, {"tokens": seq})[0]
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
    libs = _build.build(["flash_attention", "flash_decode"])
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "entry function" in line or "Used" in line or "spill" in line:
                print(f"  {name} ptxas: {line.strip()}")

    record = check_flash_attention()
    decode_record = check_flash_decode()
    check_model_on_card()
    check_decode_on_card()

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

    decode_record["launches"] = run_decode_path()

    print(json.dumps({"kernels": [record, decode_record]}))
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
