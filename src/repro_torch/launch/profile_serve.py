"""Where the serving path's time goes on the card.

Runs ``torch.profiler`` (CPU + CUDA activities) over windows of the
``launch/serve.py`` paths and prints, for each: the window's wall time, the
device's busy time (the union of kernel intervals over all streams) and
idle share, kernel time by kind (the flash-attention and flash-decode
kernels, GEMMs, the rest), the device time of the kernels launched inside
each model's named profiler ranges (:data:`SPANS`), and the top kernels by
device time.

Batch workload (the default):

* ``direct``: ``--forwards`` whole-model forwards of one request, back to
  back on one thread and the default stream;
* ``serve``: one warm-up request and ``--requests`` streamed requests
  through the planned pipeline (one host thread and CUDA stream per
  stage), after an unprofiled round that warms every stage.

Decode workload (``--workload decode``): one window over the served decode
stream (a warm-up stream, then ``--requests`` prompts submitted at once
through the continuous batch), after an unprofiled stream that warms every
stage.

The recurrent families (``--arch rwkv6-1.6b`` or ``recurrentgemma-9b``)
and the encoder-decoder one (``whisper-tiny``), which the serving runtimes
do not bind, run through the model API: one window of ``--forwards``
forwards of a ``(--requests, --seq)`` batch (last token's logits; whisper:
after encoding ``--requests`` clips of n_frames stub frame embeddings from
a numpy seed), and one of ``--max-new-tokens`` greedy decode steps of
``--requests`` rows after a ``--prompt-len`` prompt went into the cache
(rwkv6: in one call; recurrentgemma and whisper: token by token; whisper's
cache built from its encoder's memory of the same clips).

Training (``--train-steps N``, every family): one window of N train
steps (``launch/steps.py``'s ``make_train_step``, the AdamW settings of
``launch/train.py``) of ``--requests`` rows x ``--seq`` tokens (the vlm:
after its patches) from its ``step_batch``, in loss chunks of its
``loss_chunk``, after one unprofiled step; each backward kernel's
launches are their own kind.  The update is the driver's functional one
unless ``launch/steps.py``'s ``donate_update`` says it does not fit on the
card (qwen2-vl-72b): then it is written into the state
(``make_train_step(donate=True)``).  ``--layers L`` cuts the model to its
first L layers.

A CNN of the paper's zoo (``--model cnn:<Name>`` or
``synthetic-cnn:<f>``; fp32, TF32 off as the reference's function): one
window of ``--forwards`` direct single-image forwards, and one of a
warm-up request plus ``--requests`` single-image requests streamed through
the ``--stages``-stage ``--strategy`` plan (``cnn_stage_fns``, one host
thread and CUDA stream per stage), after an unprofiled round.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --seq 1024 --requests 8
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --arch rwkv6-1.6b --seq 1024 --requests 4 --prompt-len 1024
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --arch whisper-tiny --seq 448 --requests 16 --prompt-len 4
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --model cnn:ResNet50 --requests 64
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --train-steps 3 --requests 8 --seq 1024 [--arch rwkv6-1.6b]
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --train-steps 3 --requests 8 --seq 1024 --arch qwen2-vl-72b \\
        --layers 3
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --workload decode --decode-concurrency 8 --max-context 2048 \\
        --prompt-len 1024 --max-new-tokens 64 --requests 16 \\
        --plan-device-bytes 21000000000
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.api import DeploymentSpec
from repro_torch.launch import serve
from repro_torch.models import api, cnn, lm, rglru, whisper

KINDS = (("flash_attention", ("flash_attention",)),
         # flash_attention_bwd's kernels (D, dK/dV, dQ; fp32 and mma routes)
         ("flash_attention_bwd", ("dkdv_", "dq_kernel<", "dq_mma_kernel<",
                                  "dsk_mma_kernel<")),
         ("flash_decode", ("flash_decode",)),
         # the scans' backward kernels (rwkv6's gradient and du passes)
         # before their forwards, whose keys the rglru one also holds
         ("rwkv6_scan_bwd", ("rwkv6_bwd", "rwkv6_du")),
         ("rglru_scan_bwd", ("rglru_bwd",)),
         ("rwkv6_scan", ("rwkv6_scan",)),
         # rglru_scan's step and staged kernels
         ("rglru_scan", ("rglru_",)),
         ("matmul_qi8", ("matmul_qi8",)),
         # cuDNN's convolution kernels (fprop, implicit GEMM, winograd)
         # before the GEMM keys, which their names also hold
         ("conv", ("conv", "fprop", "implicit", "winograd", "cudnn")),
         ("gemm", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
         ("elementwise", ("elementwise",)))


# the models' spans (profiling/spans.py): the kernels their ops launch are
# summed apart (recurrentgemma's pointwise gates around rglru_scan)
SPANS = (rglru.GATES_SPAN,)


def _kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def _union_us(spans: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def span_device_s(prof, name: str) -> Tuple[float, int, int]:
    """(device seconds, kernels, ranges) of the kernels launched by the ops
    that ran inside the CPU ranges called ``name``, on the range's
    thread."""
    events = prof.events()
    ranges = [(e.thread, e.time_range.start, e.time_range.end)
              for e in events
              if e.name == name and e.device_type == DeviceType.CPU]
    total, n = 0.0, 0
    for e in events:
        if (e.device_type != DeviceType.CPU or e.name == name
                or not e.kernels):
            continue
        if any(th == e.thread and lo <= e.time_range.start
               and e.time_range.end <= hi for th, lo, hi in ranges):
            total += sum(k.duration for k in e.kernels)
            n += len(e.kernels)
    return total / 1e6, n, len(ranges)


def summarize(prof, wall_s: float, label: str, top: int = 10) -> Dict:
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_s = _union_us([(e.time_range.start, e.time_range.end)
                        for e in kernels]) / 1e6
    by_kind: Dict[str, float] = {}
    by_name: Dict[str, Tuple[int, float]] = {}
    for e in kernels:
        dt = (e.time_range.end - e.time_range.start) / 1e6
        by_kind[_kind(e.name)] = by_kind.get(_kind(e.name), 0.0) + dt
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + dt)
    print(f"[{label}] wall {wall_s * 1e3:.3f} ms, {len(kernels)} kernels, "
          f"device busy {busy_s * 1e3:.3f} ms, idle share "
          f"{1 - busy_s / wall_s:.3f}" if kernels else
          f"[{label}] wall {wall_s * 1e3:.3f} ms: the profiler recorded no "
          f"device activity")
    for kind, t in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"[{label}]   {kind}: {t * 1e3:.3f} ms summed kernel time")
    for name in SPANS:
        t, n, ranges = span_device_s(prof, name)
        if ranges:
            print(f"[{label}]   range {name}: {t * 1e3:.3f} ms summed "
                  f"kernel time, {n} kernels in {ranges} ranges")
    for name, (n, t) in sorted(by_name.items(),
                               key=lambda kv: -kv[1][1])[:top]:
        print(f"[{label}]     {t * 1e3:9.3f} ms  x{n:<5d} {name[:90]}")
    return {"wall_s": wall_s, "busy_s": busy_s, "kernels": len(kernels),
            "by_kind_s": by_kind}


def profiled(fn: Callable[[], object]):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def profile_model(args: argparse.Namespace, forwards: int) -> None:
    """The model-API windows of a recurrent or the encoder-decoder family
    (module docstring)."""
    batch, decode_steps = args.requests, args.max_new_tokens
    mod = configs.get(args.arch)
    cfg = mod.smoke_config() if args.smoke else mod.config()
    dev = torch.device("cuda")
    params = api.init(cfg, dev, torch.Generator(dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    tokens, prompt = (torch.from_numpy(rng.integers(
        0, cfg.vocab, (batch, n), dtype=np.int64))
        for n in (args.seq, args.prompt_len))
    inputs = {"tokens": tokens}
    if cfg.family == "encdec":
        inputs["frames"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.n_frames, cfg.d_model), dtype=np.float32)).to(
                dev, cfg.dtype)

    def run_forwards():
        for _ in range(forwards):
            api.forward(cfg, params, inputs, last_token_only=True)

    run_forwards()
    torch.cuda.synchronize()
    prof, wall = profiled(run_forwards)
    summarize(prof, wall, f"{cfg.name} forward ({batch}, {args.seq}) "
                          f"x{forwards}")

    max_len = args.prompt_len + 2 * decode_steps
    if cfg.family == "encdec":
        cache = whisper.init_cache(
            cfg, batch, max_len, dev, params=params,
            memory=whisper.encode(cfg, params, inputs["frames"]))
    else:
        cache = api.init_cache(cfg, batch, max_len, dev)
    feed = ([prompt[:, i:i + 1] for i in range(args.prompt_len)]
            if cfg.family in ("hybrid", "encdec") else [prompt])
    for tok in feed:
        logits, cache = api.decode(cfg, params, tok.to(dev), cache)
    state = {"cache": cache, "tok": logits[:, -1].argmax(-1, keepdim=True)}

    def steps():
        for _ in range(decode_steps):
            logits, state["cache"] = api.decode(cfg, params, state["tok"],
                                                state["cache"])
            state["tok"] = logits[:, -1].argmax(-1, keepdim=True)

    steps()                                     # warms the step
    torch.cuda.synchronize()
    prof, wall = profiled(steps)
    summarize(prof, wall, f"{cfg.name} decode {batch} rows x "
                          f"{decode_steps} steps")


def profile_train(args: argparse.Namespace, steps: int,
                  layers: Optional[int] = None) -> None:
    """The training window (module docstring)."""
    import dataclasses
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch import steps as train_steps
    from repro_torch.launch.train import loss_chunk, step_batch
    from repro_torch.optim import AdamWConfig
    mod = configs.get(args.arch)
    cfg = mod.smoke_config() if args.smoke else mod.config()
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    dev = torch.device("cuda")
    params, state = train_steps.init_train_state(
        cfg, dev, torch.Generator(dev).manual_seed(args.seed))
    data = SyntheticLMDataset(DataConfig(global_batch=args.requests,
                                         seq_len=args.seq, vocab=cfg.vocab))
    donate = train_steps.donate_update(
        cfg, torch.cuda.get_device_properties(dev).total_memory)
    step = train_steps.make_train_step(
        cfg, AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps + 1),
        loss_chunk=loss_chunk(cfg, args.seq), donate=donate)
    batches = [step_batch(cfg, data, i, args.requests, args.seq, dev)
               for i in range(steps + 1)]
    run = {"params": params, "state": state}

    def train(first, n):
        for b in batches[first:first + n]:
            run["params"], run["state"], _ = step(run["params"],
                                                  run["state"], b)

    torch.cuda.reset_peak_memory_stats(dev)
    train(0, 1)                                 # warms the step
    torch.cuda.synchronize()
    prof, wall = profiled(lambda: train(1, steps))
    label = (f"{cfg.name} ({cfg.n_layers} layers) train ({args.requests}, "
             f"{args.seq}) x{steps}, "
             f"{'donated' if donate else 'functional'} update")
    summarize(prof, wall, label)
    print(f"[{label}] allocator peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB over the "
          f"warm-up and the window")


def cnn_model(ref: str):
    """A ``cnn:<Name>`` or ``synthetic-cnn:<f>`` ref -> its GraphModel."""
    kind, _, rest = ref.partition(":")
    if kind == "cnn":
        return cnn.REAL_CNNS[rest]()
    if kind == "synthetic-cnn":
        return cnn.synthetic_cnn(int(rest))
    raise SystemExit(f"--model takes cnn:<Name> or synthetic-cnn:<f>, not "
                     f"{ref!r}")


def profile_cnn(args: argparse.Namespace, ref: str, forwards: int) -> None:
    """The CNN windows (module docstring)."""
    model = cnn_model(ref)
    dev = torch.device("cuda")
    params = model.init(dev, torch.Generator(dev).manual_seed(args.seed))
    dep = serve.deploy_cnn(model, params, DeploymentSpec(
        model=ref, stages=args.stages, strategy=args.strategy), dev)
    print("plan:", dep.plan.describe())
    reqs = serve.cnn_requests(model, args.requests, dev, args.seed)
    x = reqs[0][model.INPUT]

    def run_forwards():
        for _ in range(forwards):
            model.apply(params, x)

    run_forwards()
    torch.cuda.synchronize()
    prof, wall = profiled(run_forwards)
    summarize(prof, wall, f"{model.name} direct x{forwards}")
    serve.serve_stream(dep, reqs)               # warms every stage
    prof, wall = profiled(lambda: serve.serve_stream(dep, reqs))
    summarize(prof, wall, f"{model.name} serve 1+{len(reqs)}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--forwards", type=int, default=3)
    ap.add_argument("--model", default=None,
                    help="a CNN ref (cnn:<Name> or synthetic-cnn:<f>) to "
                         "profile instead of --arch")
    ap.add_argument("--train-steps", type=int, default=0,
                    help="profile this many train steps of --arch instead "
                         "of serving")
    ap.add_argument("--layers", type=int, default=None,
                    help="--train-steps: cut the model to its first "
                         "this many layers")
    extra, rest = ap.parse_known_args(argv)
    args = serve.parse_args(rest)
    if args.device != "cuda":
        raise SystemExit("profile_serve measures the card: --device cuda")
    print(torch.cuda.get_device_name(0))
    if extra.model is not None:
        # the reference's CNN forward is fp32; cuDNN would run TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        profile_cnn(args, extra.model, extra.forwards)
        return
    if extra.train_steps:
        profile_train(args, extra.train_steps, extra.layers)
        return
    if configs.get(args.arch).config().family not in serve.SERVED_FAMILIES:
        profile_model(args, extra.forwards)
        return
    if args.workload == "decode":
        cfg, params, dep, prompts = serve.setup_decode(args)

        def stream():
            return serve.serve_decode(dep, params, prompts,
                                      args.max_new_tokens)

        stream()                                # warms every stage
        prof, wall = profiled(stream)
        summarize(prof, wall, f"decode 1+{len(prompts)} streams x "
                              f"{args.max_new_tokens}")
        return
    cfg, params, dep, reqs = serve.setup(args)
    batch = {"tokens": reqs[0]}

    def forwards():
        for _ in range(extra.forwards):
            lm.forward(cfg, params, batch, last_token_only=True)

    forwards()
    torch.cuda.synchronize()
    prof, wall = profiled(forwards)
    summarize(prof, wall, f"direct x{extra.forwards}")

    serve.serve_stream(dep, reqs)               # warms every stage
    prof, wall = profiled(lambda: serve.serve_stream(dep, reqs))
    summarize(prof, wall, f"serve 1+{len(reqs)}")


if __name__ == "__main__":
    main()
