"""Where the serving path's time goes on the card.

Runs ``torch.profiler`` (CPU + CUDA activities) over windows of the
``launch/serve.py`` paths and prints, for each: the window's wall time, the
device's busy time (the union of kernel intervals over all streams) and
idle share, kernel time by kind (the flash-attention and flash-decode
kernels, GEMMs, the rest), and the top kernels by device time.

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

The recurrent families (``--arch rwkv6-1.6b`` or ``recurrentgemma-9b``),
which the serving runtimes do not bind, run through the model API: one
window of ``--forwards`` forwards of a ``(--requests, --seq)`` batch (last
token's logits), and one of ``--max-new-tokens`` greedy decode steps of
``--requests`` rows after a ``--prompt-len`` prompt went into the cache
(rwkv6: in one call; recurrentgemma: token by token).

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
        --model cnn:ResNet50 --requests 64
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
from repro_torch.models import api, cnn, lm

KINDS = (("flash_attention", ("flash_attention",)),
         ("flash_decode", ("flash_decode",)),
         ("rwkv6_scan", ("rwkv6_scan",)),
         ("rglru_scan", ("rglru_scan",)),
         ("matmul_qi8", ("matmul_qi8",)),
         # cuDNN's convolution kernels (fprop, implicit GEMM, winograd)
         # before the GEMM keys, which their names also hold
         ("conv", ("conv", "fprop", "implicit", "winograd", "cudnn")),
         ("gemm", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
         ("elementwise", ("elementwise",)))


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
    """The model-API windows of a recurrent family (module docstring)."""
    batch, decode_steps = args.requests, args.max_new_tokens
    mod = configs.get(args.arch)
    cfg = mod.smoke_config() if args.smoke else mod.config()
    dev = torch.device("cuda")
    params = api.init(cfg, dev, torch.Generator(dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    tokens, prompt = (torch.from_numpy(rng.integers(
        0, cfg.vocab, (batch, n), dtype=np.int64))
        for n in (args.seq, args.prompt_len))

    def run_forwards():
        for _ in range(forwards):
            api.forward(cfg, params, {"tokens": tokens},
                        last_token_only=True)

    run_forwards()
    torch.cuda.synchronize()
    prof, wall = profiled(run_forwards)
    summarize(prof, wall, f"{cfg.name} forward ({batch}, {args.seq}) "
                          f"x{forwards}")

    cache = api.init_cache(cfg, batch, args.prompt_len + 2 * decode_steps,
                           dev)
    feed = ([prompt[:, i:i + 1] for i in range(args.prompt_len)]
            if cfg.family == "hybrid" else [prompt])
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
