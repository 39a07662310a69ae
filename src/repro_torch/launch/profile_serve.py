"""Where the serving path's time goes on the card.

Runs ``torch.profiler`` (CPU + CUDA activities) over two windows of the
``launch/serve.py`` path and prints, for each: the window's wall time, the
device's busy time (the union of kernel intervals over all streams) and
idle share, kernel time by kind (the flash-attention kernel, GEMMs, the
rest), and the top kernels by device time.

* ``direct``: ``--forwards`` whole-model forwards of one request, back to
  back on one thread and the default stream;
* ``serve``: one warm-up request and ``--requests`` streamed requests
  through the planned pipeline (one host thread and CUDA stream per
  stage), after an unprofiled round that warms every stage.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --seq 1024 --requests 8
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import serve
from repro_torch.models import lm

KINDS = (("flash_attention", ("flash_attention",)),
         ("gemm", ("gemm", "cutlass", "xmma", "nvjet", "cublas")))


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


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--forwards", type=int, default=3)
    extra, rest = ap.parse_known_args(argv)
    args = serve.parse_args(rest)
    if args.device != "cuda":
        raise SystemExit("profile_serve measures the card: --device cuda")
    print(torch.cuda.get_device_name(0))
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
