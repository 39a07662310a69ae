"""Serving entry point: streamed prefill requests through the balanced-segmented
pipeline, on one CUDA device.

The batch workload of ``repro/launch/serve.py`` on the host backend:

1. build the arch's LayerGraph and plan it with ``--strategy`` for
   ``--stages`` devices through the front door (``deploy``);
2. split the layer list by the plan; one host thread per stage with
   queues between (paper Fig. 5 executor), each stage on its own CUDA
   stream of the one card;
3. serve a stream of requests (no inter-batch barrier), report
   throughput, latency percentiles and per-stage busy time from the
   server's ``snapshot()`` deltas, and check the first request against
   the direct forward.

Full width is the default; ``--smoke`` serves the reduced config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --stages 4 --requests 15
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
"""
from __future__ import annotations

import argparse
import itertools
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.api import DeploymentSpec, deploy
from repro_torch.configs.common import concrete_batch
from repro_torch.core.pipeline import stage_balance_metrics
from repro_torch.core.placement import PlacementPlan
from repro_torch.models import lm, lm_graph


def stage_block_counts(plan: PlacementPlan, n_blocks: int) -> List[int]:
    """Blocks per stage from a plan over the full LayerGraph (embed +
    block_i + final_norm/head nodes): count only block_* layers."""
    counts = [sum(1 for name in layers if name.startswith("block_"))
              for layers in plan.stage_layers]
    if sum(counts) != n_blocks:
        raise ValueError(f"plan covers {sum(counts)} blocks, model has "
                         f"{n_blocks}: {counts}")
    return counts


def _stage_fn(cfg: lm.LMConfig, params: lm.Params, blocks: Sequence,
              first: bool, last: bool,
              stream: Optional[torch.cuda.Stream]) -> Callable:
    def run(x_or_tokens: torch.Tensor) -> torch.Tensor:
        # the executor times this host call as the stage's busy time, and
        # the next stage reads the result on its own thread and stream:
        # finishing the stream's work before returning makes the busy
        # time device time and hands on a finished tensor
        with torch.cuda.stream(stream):
            x = (lm.embed_tokens(cfg, params, x_or_tokens) if first
                 else x_or_tokens)
            positions = lm.positions_for(x)
            for bp in blocks:
                x = lm.block(cfg, bp, x, positions)
            if last:
                x = lm.unembed(cfg, params, x[:, -1:])
            if stream is not None:
                stream.synchronize()
        return x
    return run


def make_stage_fns(cfg: lm.LMConfig, params: lm.Params,
                   counts: Sequence[int],
                   device: torch.device) -> List[Callable]:
    """Per-stage callables applying a contiguous block range (+ embed on
    stage 0, final norm and last-token unembedding on the last stage),
    each on its own CUDA stream when ``device`` is a CUDA device."""
    offsets = [0, *itertools.accumulate(counts)]
    fns = []
    for i in range(len(counts)):
        stream = (torch.cuda.Stream(device) if device.type == "cuda"
                  else None)
        fns.append(_stage_fn(cfg, params,
                             params["blocks"][offsets[i]:offsets[i + 1]],
                             i == 0, i == len(counts) - 1, stream))
    return fns


def spec_from_args(args: argparse.Namespace) -> DeploymentSpec:
    """CLI flags -> declarative DeploymentSpec (the front door)."""
    return DeploymentSpec(model=f"lm:{args.arch}:seq={args.seq}",
                          strategy=args.strategy, stages=args.stages,
                          microbatch=args.microbatch,
                          microbatch_wait_s=args.microbatch_wait_ms / 1e3,
                          max_batch=args.requests, max_wait_s=0.005)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the arch's reduced smoke config instead of "
                         "the full-width one")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on; 'cpu' runs the plain "
                         "attention in place of the CUDA kernel")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and request tokens")
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--requests", type=int, default=15)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--strategy", default="balanced",
                    choices=["balanced", "balanced_norefine", "comp"])
    ap.add_argument("--microbatch", type=int, default=1,
                    help="stage-level dynamic micro-batching bucket size "
                         "(stack up to k same-shape in-flight requests "
                         "into one call; 1 = off)")
    ap.add_argument("--microbatch-wait-ms", type=float, default=2.0,
                    help="max hold time for a micro-batch bucket to fill")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace):
    """Random weights from ``args.seed``, the plan through the front door,
    and the request tokens: (cfg, params, deployment, requests)."""
    device = resolve_device(args.device)
    mod = configs.get(args.arch)
    cfg = mod.smoke_config() if args.smoke else mod.config()
    gen = torch.Generator(device).manual_seed(args.seed)
    params = lm.init_params(cfg, device, generator=gen)
    g = lm_graph.lm_layer_graph(cfg, seq_len=args.seq)

    def fns_for(p: PlacementPlan) -> List[Callable]:
        return make_stage_fns(cfg, params,
                              stage_block_counts(p, cfg.n_layers), device)

    dep = deploy(spec_from_args(args), graph=g, stage_fn_builder=fns_for)
    rng = np.random.default_rng(args.seed)
    reqs = [concrete_batch(cfg, args.seq, 1, rng=rng, kind="prefill")["tokens"]
            for _ in range(args.requests)]
    return cfg, params, dep, reqs


def serve_stream(dep, reqs: Sequence[torch.Tensor]):
    """Serve one warm-up request, then stream ``reqs`` (no barrier).
    Returns (outputs in request order, snapshot of the stream, seconds)."""
    with dep.serve() as server:
        server.serve_batch(reqs[:1])           # warm-up
        server.start()                          # admission loop
        server.snapshot()                       # reset the delta window
        t0 = time.perf_counter()
        pending = [server.submit(r) for r in reqs]
        for req in pending:
            if not req.event.wait(600):
                raise TimeoutError(f"request {req.rid} timed out")
        seconds = time.perf_counter() - t0
        snap = server.snapshot()
    errors = [r.error for r in pending if r.error is not None]
    if errors:
        raise RuntimeError(f"{len(errors)} requests failed") from errors[0]
    return [r.result for r in pending], snap, seconds


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """Plan, serve one warm-up request and then ``args.requests`` streamed
    ones, and check the first against the direct forward.  Runs
    ``args.requests + 2`` whole-model forwards (warm-up, requests, direct
    reference).  Returns the config, weights, plan, requests, outputs,
    snapshot, wall time and the pipeline-vs-direct error."""
    cfg, params, dep, reqs = setup(args)
    outs, snap, seconds = serve_stream(dep, reqs)
    ref = lm.forward(cfg, params, {"tokens": reqs[0]}, last_token_only=True)
    err = float((outs[0] - ref).abs().max())
    return {"cfg": cfg, "params": params, "plan": dep.plan, "requests": reqs,
            "outs": outs, "snapshot": snap, "seconds": seconds,
            "max_err": err}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    res = run(args)
    pl, snap = res["plan"], res["snapshot"]
    print("plan:", pl.describe())
    print("report:", pl.report.describe())
    print("blocks per stage:", stage_block_counts(pl, res["cfg"].n_layers))
    busy = snap["stage_busy_s"]
    lat = snap["latency"]
    print(f"{len(res['outs'])} requests in {res['seconds'] * 1e3:.1f} ms "
          f"({snap['throughput_rps']:.1f} req/s)")
    print(f"latency p50/p95/p99 (ms): {lat['p50_s'] * 1e3:.1f} / "
          f"{lat['p95_s'] * 1e3:.1f} / {lat['p99_s'] * 1e3:.1f}")
    print(f"stage busy (s): {[round(b, 4) for b in busy]}")
    print(f"balance (mean/max): {stage_balance_metrics(busy)['balance']:.3f}")
    print(f"pipeline vs direct max err: {res['max_err']:.2e}")
    if not res["max_err"] < 2e-2:
        raise SystemExit(f"pipeline output differs from the direct forward "
                         f"by {res['max_err']:.2e} (bound 2e-2)")
    return res


if __name__ == "__main__":
    main()
