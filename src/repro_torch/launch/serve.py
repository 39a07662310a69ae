"""Serving entry point: streamed prefill requests through the balanced-segmented
pipeline, or token streams through the KV-aware decode pipeline, on one CUDA
device.

The batch workload (``--workload batch``, the default) of
``repro/launch/serve.py`` on the host backend:

1. build the arch's LayerGraph and plan it with ``--strategy`` for
   ``--stages`` devices through the front door (``deploy``);
2. split the layer list by the plan; one host thread per stage with
   queues between (paper Fig. 5 executor), each stage on its own CUDA
   stream of the one card;
3. serve a stream of requests (no inter-batch barrier), report
   throughput, latency percentiles and per-stage busy time from the
   server's ``snapshot()`` deltas, and check the first request against
   the direct forward.

The decode workload (``--workload decode``): plan with the
``decode_placement`` strategy at the ``(--decode-concurrency,
--max-context)`` operating point, for a planning device with
``--plan-device-bytes`` of memory per stage (unset: the reference's 8 MiB
Edge TPU), then stream ``--requests`` prompts of ``--prompt-len`` tokens,
``--max-new-tokens`` each, through the continuous-batching
:class:`~repro_torch.decode.engine.DecodeServer`.

The recurrent families (rwkv6-1.6b, recurrentgemma-9b) plan but are not
served, as in the reference: both workloads print the plan, the report and
the reference's note, and return (:func:`plan_only`).  Their runnable
surface is :mod:`repro_torch.models.api`.

Full width is the default; ``--smoke`` serves the reduced config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --stages 4 --requests 15
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --workload decode \\
        --decode-concurrency 8 --max-context 2048 --prompt-len 1024 \\
        --max-new-tokens 64 --requests 16 --plan-device-bytes 21000000000
"""
from __future__ import annotations

import argparse
import itertools
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.api import DeploymentSpec, deploy, plan
from repro_torch.configs.common import concrete_batch
from repro_torch.core.edge_tpu_model import EdgeTPUSpec
from repro_torch.core.pipeline import stage_balance_metrics
from repro_torch.core.placement import PlacementPlan
from repro_torch.decode import DECODE_FAMILIES
from repro_torch.models import lm, lm_graph

# the families the prefill serving runtime binds (the reference's list)
SERVED_FAMILIES = ("dense", "moe", "vlm")


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
    common = dict(model=f"lm:{args.arch}:seq={args.seq}",
                  stages=args.stages, microbatch=args.microbatch,
                  microbatch_wait_s=args.microbatch_wait_ms / 1e3,
                  max_batch=args.requests, max_wait_s=0.005)
    if args.workload == "decode":
        # decode plans at the (concurrency, max_context) operating point
        # with the per-token cost regime; see repro_torch.decode
        return DeploymentSpec(strategy="decode_placement",
                              workload="decode",
                              max_context=args.max_context,
                              decode_concurrency=args.decode_concurrency,
                              **common)
    return DeploymentSpec(strategy=args.strategy, **common)


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
    ap.add_argument("--workload", default="batch",
                    choices=["batch", "decode"],
                    help="'batch': prefill request/response serving "
                         "(default).  'decode': KV-cache-aware placement "
                         "(decode_placement strategy) + continuous-"
                         "batching token streaming")
    ap.add_argument("--max-context", type=int, default=128,
                    help="decode operating point: per-sequence KV budget "
                         "(prompt + generated tokens)")
    ap.add_argument("--decode-concurrency", type=int, default=4,
                    help="decode operating point: concurrent sequences in "
                         "the running batch")
    ap.add_argument("--max-new-tokens", type=int, default=16,
                    help="tokens generated per decode request")
    ap.add_argument("--prompt-len", type=int, default=8,
                    help="tokens per decode prompt")
    ap.add_argument("--plan-device-bytes", type=int, default=0,
                    help="decode planning: memory per stage of the device "
                         "the plan is priced for (0: the reference's 8 MiB "
                         "Edge TPU)")
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


def setup_decode(args: argparse.Namespace):
    """Random weights from ``args.seed``, the decode plan through the front
    door (the config and a ``--plan-device-bytes`` planning device beside
    the graph), and the prompts: (cfg, params, deployment, prompts)."""
    device = resolve_device(args.device)
    mod = configs.get(args.arch)
    cfg = mod.smoke_config() if args.smoke else mod.config()
    params = lm.init_params(cfg, device,
                            torch.Generator(device).manual_seed(args.seed))
    g = lm_graph.lm_layer_graph(cfg, seq_len=args.seq)
    base = (EdgeTPUSpec(onchip_bytes=args.plan_device_bytes)
            if args.plan_device_bytes else None)
    dep = deploy(spec_from_args(args), graph=g, cfg=cfg, base_spec=base)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab, size=args.prompt_len)
               .astype(np.int32) for _ in range(args.requests)]
    return cfg, params, dep, prompts


def serve_decode(dep, params, prompts: Sequence[np.ndarray],
                 max_new_tokens: int) -> Dict[str, Any]:
    """One warm-up stream of 2 tokens, then every prompt submitted at once.
    Returns the token lists (in prompt order), the scheduler's snapshots
    of the warm-up and of the stream, the stream's wall seconds, and the
    engine's per-stage busy seconds over the stream."""
    with dep.serve(start=True, params=params) as srv:
        srv.submit(prompts[0], max_new_tokens=2).result(600)     # warm-up
        warm = srv.snapshot()                   # resets the delta window
        busy0 = srv.engine.pipe.busy_snapshot()
        t0 = time.perf_counter()
        reqs = [srv.submit(p, max_new_tokens=max_new_tokens)
                for p in prompts]
        outs = [r.result(600) for r in reqs]
        seconds = time.perf_counter() - t0
        snap = srv.snapshot()
        busy = [b - a for a, b in zip(busy0, srv.engine.pipe.busy_snapshot())]
    return {"outs": outs, "warmup": warm, "snapshot": snap,
            "seconds": seconds, "stage_busy_s": busy}


def run_decode(args: argparse.Namespace) -> Dict[str, Any]:
    """``--workload decode``: KV-aware placement + continuous batching.
    Returns :func:`serve_decode`'s results plus the config, weights, plan
    and prompts."""
    cfg, params, dep, prompts = setup_decode(args)
    res = serve_decode(dep, params, prompts, args.max_new_tokens)
    res.update(cfg=cfg, params=params, plan=dep.plan, prompts=prompts)
    return res


def plan_only(args: argparse.Namespace) -> Dict[str, Any]:
    """The reference's plan-and-note path for a family its serving runtimes
    do not bind: plan the arch through ``lm_graph`` (``decode_placement``
    for ``--workload decode``), print the plan, the report and the note.
    Returns the config, the plan and the note."""
    resolve_device(args.device)
    mod = configs.get(args.arch)
    cfg = mod.smoke_config() if args.smoke else mod.config()
    g = lm_graph.lm_layer_graph(cfg, seq_len=args.seq)
    if args.workload == "decode":
        base = (EdgeTPUSpec(onchip_bytes=args.plan_device_bytes)
                if args.plan_device_bytes else None)
        pl = plan(spec_from_args(args), graph=g, cfg=cfg, base_spec=base)
        note = (f"note: family {cfg.family!r} ({args.arch}) plans decode "
                f"placement (above) but the continuous-batching runtime "
                f"binds the scan-block families {DECODE_FAMILIES}; pick one "
                f"of those archs to stream tokens")
    else:
        pl = plan(spec_from_args(args), graph=g)
        note = (f"note: family {cfg.family!r} ({args.arch}) plans via "
                f"lm_graph (above) but the pipeline serving runtime binds "
                f"the scan-block families {SERVED_FAMILIES}; pick one of "
                f"those archs to serve, or use --workload decode for "
                f"KV-aware decode planning")
    print("plan:", pl.describe())
    print("report:", pl.report.describe())
    print(note)
    return {"cfg": cfg, "plan": pl, "note": note}


def main_decode(args: argparse.Namespace) -> Dict[str, Any]:
    res = run_decode(args)
    pl, snap, outs = res["plan"], res["snapshot"], res["outs"]
    rep = pl.report
    print("plan:", pl.describe())
    print("report:", rep.describe())
    print("blocks per stage:", stage_block_counts(pl, res["cfg"].n_layers))
    print(f"stage KV bytes {list(rep.stage_kv_bytes)} of "
          f"{rep.stage_kv_cap_bytes[0]} per stage, KV headroom "
          f"{rep.kv_headroom_pct:.1f}%")
    if not all(len(o) == args.max_new_tokens for o in outs):
        raise SystemExit(f"streams returned {[len(o) for o in outs]} "
                         f"tokens, expected {args.max_new_tokens} each")
    n_gaps = snap["tokens"] - len(outs)
    print(f"{len(outs)} streams x {args.max_new_tokens} tokens in "
          f"{res['seconds'] * 1e3:.1f} ms "
          f"({snap['tokens'] / res['seconds']:.1f} tok/s, "
          f"{snap['steps']} batched steps)")
    print(f"inter-token p50/p95 (ms): {snap['inter_token_p50_s'] * 1e3:.2f}"
          f" / {snap['inter_token_p95_s'] * 1e3:.2f} ({n_gaps} gaps)")
    busy = res["stage_busy_s"]
    print(f"stage busy (s): {[round(b, 4) for b in busy]}, balance "
          f"(mean/max) {stage_balance_metrics(busy)['balance']:.3f}")
    print(f"modeled decode: {rep.decode_tokens_per_s:.1f} tok/s")
    return res


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    if configs.get(args.arch).config().family not in SERVED_FAMILIES:
        return plan_only(args)
    if args.workload == "decode":
        return main_decode(args)
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
