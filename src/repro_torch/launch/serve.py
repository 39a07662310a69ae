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

``--backend spmd`` runs the batch workload's whole request set as one
batch through the SPMD tier
(:class:`~repro_torch.launch.pipeline_spmd.SpmdPipelineExecutor`: the GPipe
schedule over one CUDA stream per stage, ``--microbatch`` microbatches,
the stage weights streamed during bring-up; dense and moe archs, fp32
activations as in the reference): a warm-up batch, the timed batch,
predicted and achieved stage times, and the first request against the
direct forward in the executor's numerics.  ``--cards K`` spreads the
stages over K cards (stage ``s`` on ``cuda:(s * K // stages)``; it raises
when fewer are visible): the weights are then made a block at a time and
kept on the host, so a model that no card holds is served, and the
first request is held against the executor's stage functions composed
without the schedule.

The decode workload (``--workload decode``): plan with the
``decode_placement`` strategy at the ``(--decode-concurrency,
--max-context)`` operating point, for a planning device with
``--plan-device-bytes`` of memory per stage (unset: the reference's 8 MiB
Edge TPU), then stream ``--requests`` prompts of ``--prompt-len`` tokens,
``--max-new-tokens`` each, through the continuous-batching
:class:`~repro_torch.decode.engine.DecodeServer`.

CNNs (the paper's Table-1 zoo) are served through the library, not this
CLI (the reference's CLI is LM-only): :func:`cnn_stage_fns` is the stage
function builder to hand ``deploy(DeploymentSpec(model="cnn:<Name>"),
stage_fn_builder=...)``.

The recurrent families (rwkv6-1.6b, recurrentgemma-9b) and the
encoder-decoder one (whisper-tiny) plan but are not served, as in the
reference: both workloads print the plan, the report and the reference's
note, and return (:func:`plan_only`).  Their runnable surface is
:mod:`repro_torch.models.api` (whisper's decode cache built from its
encoder's memory by :func:`repro_torch.models.whisper.init_cache`).

Both workloads serve the attention families: dense (qwen3-1.7b,
qwen2.5-14b, minitron-4b, phi3-mini-3.8b), moe (granite-moe-1b-a400m,
phi3.5-moe-42b-a6.6b) and vlm (qwen2-vl-72b, whose requests are text: the
stages get its default (3, B, S) M-RoPE positions).  Full width is the
default; ``--smoke`` serves the reduced config.  ``--moe-capacity-factor``
overrides a moe config's routing capacity (``n_experts / top_k`` drops no
token, so the grouping of a forward changes no token's output).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --stages 4 --requests 15
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --backend spmd \\
        --seq 1024 --requests 8 --microbatch 4
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch phi3.5-moe-42b-a6.6b --backend spmd --stages 4 --cards 4 \\
        --seq 1024 --requests 8 --microbatch 4 \\
        --plan-device-bytes 80000000000
    PYTHONPATH=src python -m repro_torch.launch.serve --workload decode \\
        --decode-concurrency 8 --max-context 2048 --prompt-len 1024 \\
        --max-new-tokens 64 --requests 16 --plan-device-bytes 21000000000
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.api import DeploymentSpec, deploy, plan
from repro_torch.checkpoint.store import tree_map
from repro_torch.configs.common import concrete_batch
from repro_torch.core.edge_tpu_model import EdgeTPUSpec
from repro_torch.core.pipeline import PipelineExecutor, stage_balance_metrics
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


def thread_streams(device: torch.device
                   ) -> Callable[[], Optional[torch.cuda.Stream]]:
    """A getter of the calling thread's own CUDA stream on ``device``,
    made at the thread's first call (``None`` off CUDA).  The workers of a
    replicated stage all call one stage function: on one shared stream
    each worker's ``synchronize()`` would wait for the others' queued
    work, so the replicas would run one after the other and each busy
    time would count the others' work.  On its own stream a worker waits
    for its own work only."""
    if device.type != "cuda":
        return lambda: None
    local = threading.local()

    def get() -> torch.cuda.Stream:
        stream = getattr(local, "stream", None)
        if stream is None:
            stream = local.stream = torch.cuda.Stream(device)
        return stream
    return get


def _record_inputs(stream: Optional[torch.cuda.Stream],
                   tensors: Sequence[torch.Tensor]) -> None:
    """Tell the caching allocator that ``tensors``, made on another
    thread's stream, are used on ``stream`` too, so their memory is not
    handed out again before ``stream``'s work on them is done."""
    if stream is None:
        return
    for t in tensors:
        if t.is_cuda:
            t.record_stream(stream)


def _stage_fn(cfg: lm.LMConfig, params: lm.Params, blocks: Sequence,
              first: bool, last: bool,
              streams: Callable[[], Optional[torch.cuda.Stream]]
              ) -> Callable:
    def run(x_or_tokens: torch.Tensor) -> torch.Tensor:
        # the executor times this host call as the stage's busy time, and
        # the next stage reads the result on its own thread and stream:
        # finishing this worker's stream before returning makes the busy
        # time device time and hands on a finished tensor
        stream = streams()
        with torch.cuda.stream(stream):
            _record_inputs(stream, [x_or_tokens])
            x = (lm.embed_tokens(cfg, params, x_or_tokens) if first
                 else x_or_tokens)
            # vlm: the (3, B, S) default, which the reference's stage
            # reaches by indexing (1, S) positions past their first axis
            positions = lm.positions_for(cfg, x)
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
    each calling thread on its own CUDA stream when ``device`` is a CUDA
    device (:func:`thread_streams`)."""
    device = torch.device(device)
    offsets = [0, *itertools.accumulate(counts)]
    return [_stage_fn(cfg, params,
                      params["blocks"][offsets[i]:offsets[i + 1]],
                      i == 0, i == len(counts) - 1, thread_streams(device))
            for i in range(len(counts))]


def _cnn_stage_fn(model, params, layers: Sequence[str],
                  streams: Callable[[], Optional[torch.cuda.Stream]]
                  ) -> Callable:
    def run(boundary: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        # as _stage_fn: the stage's busy time is device time, and the next
        # stage gets finished tensors
        stream = streams()
        with torch.cuda.stream(stream):
            _record_inputs(stream, list(boundary.values()))
            out = model.apply_subset(params, boundary, layers)
            if stream is not None:
                stream.synchronize()
        return out
    return run


def cnn_stage_fns(model, params, plan: PlacementPlan,
                  device) -> List[Callable]:
    """Per-stage callables of a CNN ``GraphModel`` (``models/cnn.py``):
    stage i runs ``model.apply_subset(params, boundary, layers)`` over the
    plan's i-th layer range, each calling thread (a replicated stage has
    one a replica) on its own CUDA stream when ``device`` is a CUDA
    device.  A request is ``{GraphModel.INPUT: x}`` with x (B, H, W, C)
    on ``device``; the last stage returns ``{model.output: y}``.  Pass
    ``lambda p: cnn_stage_fns(model, params, p, device)`` to
    ``deploy(..., stage_fn_builder=)``."""
    device = torch.device(device)
    return [_cnn_stage_fn(model, params, layers, thread_streams(device))
            for layers in plan.stage_layers]


def deploy_cnn(model, params, spec: DeploymentSpec, device,
               base_spec: Optional[EdgeTPUSpec] = None):
    """``deploy(spec)`` over ``model``'s own graph with
    :func:`cnn_stage_fns` as the stage function builder (resizes rebuild
    the stages on the same weights)."""
    return deploy(spec, graph=model.to_layer_graph(), base_spec=base_spec,
                  stage_fn_builder=lambda p: cnn_stage_fns(model, params, p,
                                                           device))


def cnn_requests(model, n: int, device, seed: int = 0
                 ) -> List[Dict[str, torch.Tensor]]:
    """``n`` single-image requests ``{GraphModel.INPUT: x}``, x (1, H, W,
    C) drawn from ``seed`` on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(seed)
    return [{model.INPUT: torch.randn((1,) + tuple(model.input_shape),
                                      generator=gen, device=device)}
            for _ in range(n)]


def spec_from_args(args: argparse.Namespace) -> DeploymentSpec:
    """CLI flags -> declarative DeploymentSpec (the front door).

    ``--device-budget`` switches to the joint cuts+replicas placement
    strategy over that many devices; otherwise ``--stages`` identical
    devices, one per stage, with the requested split strategy."""
    common = dict(
        model=f"lm:{args.arch}:seq={args.seq}",
        microbatch=args.microbatch,
        microbatch_wait_s=args.microbatch_wait_ms / 1e3,
        max_batch=args.requests, max_wait_s=0.005,
        cost_source=args.cost_source,
        hedge_after=args.hedge_after_ms / 1e3 or None,
        stage_loss_retries=args.stage_loss_retries,
        deadline_ms=args.deadline_ms or None,
        shed_policy=args.shed_policy,
        drift_threshold=args.drift_threshold,
        canary_requests=args.canary_requests,
        backend=args.backend)
    if args.workload == "decode":
        # decode plans at the (concurrency, max_context) operating point
        # with the per-token cost regime; see repro_torch.decode
        return DeploymentSpec(strategy="decode_placement",
                              stages=args.stages, workload="decode",
                              max_context=args.max_context,
                              decode_concurrency=args.decode_concurrency,
                              **common)
    if args.device_budget:
        # joint cuts+replicas search: a bottleneck stage may get k devices
        # (round-robin fan-out in the executor, order-restoring fan-in)
        return DeploymentSpec(strategy="placement",
                              device_budget=args.device_budget, **common)
    return DeploymentSpec(strategy=args.strategy, stages=args.stages,
                          **common)


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
    ap.add_argument("--backend", default="host", choices=["host", "spmd"],
                    help="execution tier: 'host' (threaded stage workers, "
                         "streaming admission) or 'spmd' (the plan lowered "
                         "onto one CUDA stream per stage: the GPipe "
                         "schedule over --microbatch microbatches with "
                         "overlapped weight streaming; the requests run "
                         "as one batch)")
    ap.add_argument("--cards", type=int, default=1,
                    help="--backend spmd: spread the stages over this many "
                         "cards (cuda:0 .. cuda:K-1, contiguous groups of "
                         "stages); raises when fewer are visible or K > "
                         "--stages.  Above 1 the weights are made on the "
                         "first card a block at a time and kept on the "
                         "host, and the pipeline is checked against its "
                         "stage functions composed without the schedule")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="stage-level dynamic micro-batching bucket size "
                         "(stack up to k same-shape in-flight requests "
                         "into one call; 1 = off)")
    ap.add_argument("--microbatch-wait-ms", type=float, default=2.0,
                    help="max hold time for a micro-batch bucket to fill")
    ap.add_argument("--device-budget", type=int, default=0,
                    help="plan over this many devices with replicated "
                         "bottleneck stages (the 'placement' strategy; "
                         "0 = off, use --stages identical devices, one "
                         "per stage)")
    ap.add_argument("--hedge-after-ms", type=float, default=0.0,
                    help="speculatively re-dispatch an item stuck on a "
                         "replicated stage for this long to another "
                         "replica (first result wins; 0 = off)")
    ap.add_argument("--stage-loss-retries", type=int, default=0,
                    help="re-admit a request that crossed a dead stage "
                         "this many times (survives degraded-mode "
                         "replans; 0 = fail fast)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request latency budget: a request past it "
                         "completes with DeadlineExceeded at admission or "
                         "merge exit instead of waiting unbounded (0 = "
                         "off)")
    ap.add_argument("--shed-policy", default="none",
                    choices=["none", "deadline"],
                    help="'deadline': shed requests at admission when the "
                         "queue-delay estimate (in_flight x service pace) "
                         "would outlive their deadline budget; callers "
                         "get Overloaded + a jittered retry_after_s hint")
    ap.add_argument("--drift-threshold", type=float, default=0.0,
                    help="relative modeled-vs-observed per-stage drift "
                         "past which the self-healing controller replans "
                         "from live telemetry (0 = loop off)")
    ap.add_argument("--canary-requests", type=int, default=4,
                    help="held-aside requests validating a candidate "
                         "executor before a guarded reconfigure commits")
    ap.add_argument("--cost-source", default="analytic",
                    help="where the planner's per-depth costs come from: "
                         "'analytic' (closed-form device model), "
                         "'trace:<path>' (a repro_torch.profiling "
                         "ProfileTrace artifact), or 'calibrated:<path>' "
                         "(analytic model least-squares-fit to that "
                         "trace)")
    ap.add_argument("--fleet", default="",
                    help="path to a FleetSpec JSON document: serve N "
                         "models on one shared device pool (SLO-driven "
                         "pool split, weighted-fair admission, "
                         "autoscaling) and drive the synthetic traffic "
                         "scenario against it (sleep-based stages: the "
                         "card is not used); ignores the single-model "
                         "flags")
    ap.add_argument("--fleet-windows", type=int, default=10,
                    help="traffic windows per fleet scenario phase")
    ap.add_argument("--fleet-service-ms", type=float, default=6.0,
                    help="synthetic whole-model service time per fleet "
                         "member (sleep-based stage fns)")
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
                    help="memory per stage of the device the plan is "
                         "priced for (0: the reference's 8 MiB Edge TPU); "
                         "one card's, so the planner's memory check sees "
                         "each card")
    ap.add_argument("--moe-capacity-factor", type=float, default=0.0,
                    help="moe archs: the routing capacity factor (0: the "
                         "config's; n_experts / top_k drops no token)")
    return ap.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> lm.LMConfig:
    """The arch's full-width (or ``--smoke``) config, with
    ``--moe-capacity-factor`` applied to a moe config."""
    mod = configs.get(args.arch)
    cfg = mod.smoke_config() if args.smoke else mod.config()
    if args.moe_capacity_factor and cfg.family == "moe":
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=args.moe_capacity_factor)
    return cfg


def setup(args: argparse.Namespace):
    """Random weights from ``args.seed``, the plan through the front door,
    and the request tokens: (cfg, params, deployment, requests)."""
    device = resolve_device(args.device)
    cfg = config_from_args(args)
    gen = torch.Generator(device).manual_seed(args.seed)
    # over several cards the model may be one that no card holds: made on
    # the card a block at a time, kept on the host and streamed from there
    params = lm.init_params(
        cfg, device, generator=gen,
        keep_on=torch.device("cpu") if args.cards > 1 else None)
    g = lm_graph.lm_layer_graph(cfg, seq_len=args.seq)

    def fns_for(p: PlacementPlan) -> List[Callable]:
        return make_stage_fns(cfg, params,
                              stage_block_counts(p, cfg.n_layers), device)

    base = (EdgeTPUSpec(onchip_bytes=args.plan_device_bytes)
            if args.plan_device_bytes else None)
    dep = deploy(spec_from_args(args), graph=g, stage_fn_builder=fns_for,
                 base_spec=base)
    rng = np.random.default_rng(args.seed)
    reqs = [concrete_batch(cfg, args.seq, 1, rng=rng, kind="prefill")["tokens"]
            for _ in range(args.requests)]
    return cfg, params, dep, reqs


def serve_stream(dep, reqs: Sequence[torch.Tensor],
                 canaries: Optional[Sequence[Any]] = None):
    """Serve one warm-up request, then stream ``reqs`` (no barrier).
    With ``canaries``, a self-healing controller
    (:meth:`~repro_torch.api.Deployment.self_heal` over those held-aside
    payloads) watches the stream on its own thread, as the reference's
    ``--drift-threshold`` does; its windows, commits, rollbacks, state and
    events land in the snapshot under ``"self_heal"``, and the executor's
    ``health_snapshot()`` under ``"health"``.  Returns (outputs in request
    order, snapshot of the stream, seconds)."""
    with dep.serve() as server:
        server.serve_batch(reqs[:1])           # warm-up
        server.start()                          # admission loop
        healer = (dep.self_heal(canaries).start() if canaries is not None
                  else None)
        server.snapshot()                       # reset the delta window
        t0 = time.perf_counter()
        pending = [server.submit(r) for r in reqs]
        for req in pending:
            if not req.event.wait(600):
                raise TimeoutError(f"request {req.rid} timed out")
        seconds = time.perf_counter() - t0
        snap = server.snapshot()
        # cumulative over the warm-up and the stream: hedged duplicates,
        # failover re-dispatches and live replicas per stage
        snap["health"] = server.executor.health_snapshot()
        if healer is not None:
            healer.stop()
            snap["self_heal"] = {
                "windows": healer.windows, "commits": healer.commits,
                "rollbacks": healer.rollbacks, "state": healer.state,
                "events": list(healer.events)}
    errors = [r.error for r in pending if r.error is not None]
    if errors:
        raise RuntimeError(f"{len(errors)} requests failed") from errors[0]
    return [r.result for r in pending], snap, seconds


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """Plan, serve one warm-up request and then ``args.requests`` streamed
    ones (under the self-healing controller when ``--drift-threshold`` is
    set, its canaries the first ``--canary-requests`` requests), and
    check the first against the direct forward.  Runs ``args.requests +
    2`` whole-model forwards (warm-up, requests, direct reference), plus
    any hedged duplicates and canary runs.  Returns the config, weights,
    plan, requests, outputs, snapshot, wall time and the pipeline-vs-direct
    error."""
    cfg, params, dep, reqs = setup(args)
    canaries = (reqs[:args.canary_requests] if args.drift_threshold > 0
                else None)
    outs, snap, seconds = serve_stream(dep, reqs, canaries)
    ref = lm.forward(cfg, params, {"tokens": reqs[0]}, last_token_only=True)
    err = float((outs[0] - ref).abs().max())
    return {"cfg": cfg, "params": params, "plan": dep.plan,
            "requests": reqs, "outs": outs, "snapshot": snap,
            "seconds": seconds, "max_err": err}


def run_spmd(args: argparse.Namespace) -> Dict[str, Any]:
    """``--backend spmd``: the request set as one batch through the SPMD
    executor (``--microbatch`` microbatches) on a mesh of ``--cards``
    cards: a warm-up batch of one request, the timed batch, predicted and
    achieved stage times, and the first request's last-token logits
    against a reference in the executor's numerics (fp32 activations on
    the model's weights made fp32): the direct forward on one card; over
    several, the executor's own stage functions composed without the
    schedule (:meth:`SpmdPipelineExecutor.compose`), since no card need
    hold the model.  Exits when the plan has replicated stages (the front
    door fell back to the host executor).  Returns the config, weights,
    plan, requests, outputs, the batch's stats, the stage times, wall
    time, the pipeline-vs-reference error and the hops' peer access."""
    from .pipeline_spmd import default_stage_mesh, peer_access

    mesh = default_stage_mesh(args.stages, args.device, cards=args.cards)
    cfg, params, dep, reqs = setup(args)
    ex = dep.executor(backend="spmd", model=cfg, params=params, mesh=mesh,
                      n_microbatches=max(1, args.microbatch),
                      batch_size=args.requests, seq_len=args.seq)
    if isinstance(ex, PipelineExecutor):        # replicated-plan fallback
        ex.stop()
        raise SystemExit("plan has replicated stages; rerun without "
                         "--device-budget or use --backend host")
    rows = [r[0] for r in reqs]                 # (seq,) token rows
    with ex:
        ex.run_batch(rows[:1])                  # warm-up
        t0 = time.perf_counter()
        outs, stats = ex.run_batch(rows)
        seconds = time.perf_counter() - t0
        pred = ex.predicted_stage_times()
        ach = ex.achieved_stage_times()
        if args.cards > 1:
            ref = ex.compose(reqs[0])[:, -1:]
    if args.cards == 1:
        ref = lm.forward(cfg, tree_map(torch.Tensor.float, params),
                         {"tokens": reqs[0]}, last_token_only=True)
    err = float((outs[0][-1:] - ref[0].to(outs[0].device)).abs().max())
    return {"cfg": cfg, "params": params, "plan": dep.plan,
            "requests": reqs, "outs": outs, "stats": stats,
            "seconds": seconds, "predicted_s": pred, "achieved_s": ach,
            "max_err": err, "cards": [str(d) for d in mesh.devices],
            "peer_access": peer_access(mesh)}


def main_spmd(args: argparse.Namespace) -> Dict[str, Any]:
    res = run_spmd(args)
    pl, stats = res["plan"], res["stats"]
    print("plan:", pl.describe())
    print("report:", pl.report.describe())
    print("blocks per stage:", stage_block_counts(pl, res["cfg"].n_layers))
    print("stage devices:", res["cards"], "peer access of the hops:",
          res["peer_access"] or "none (one card)")
    print(f"{len(res['outs'])} requests in {res['seconds'] * 1e3:.1f} ms "
          f"({stats['items_per_s']:.1f} req/s, "
          f"m={stats['n_microbatches']}, weight-stream fill "
          f"{stats['fill_s'] * 1e3:.0f} ms, blocked "
          f"{stats['fill_blocked_s'] * 1e3:.0f} ms)")
    print("predicted stage times (s):",
          [round(t, 4) for t in res["predicted_s"]])
    print("achieved stage times (s): ",
          [round(t, 4) for t in res["achieved_s"]])
    what = "direct" if len(set(res["cards"])) == 1 else "composed"
    print(f"pipeline vs {what} max err: {res['max_err']:.2e}")
    if not res["max_err"] < 2e-2:
        raise SystemExit(f"pipeline output differs from the {what} forward "
                         f"by {res['max_err']:.2e} (bound 2e-2)")
    return res


def setup_decode(args: argparse.Namespace):
    """Random weights from ``args.seed``, the decode plan through the front
    door (the config and a ``--plan-device-bytes`` planning device beside
    the graph), and the prompts: (cfg, params, deployment, prompts)."""
    device = resolve_device(args.device)
    cfg = config_from_args(args)
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
    cfg = config_from_args(args)
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


def run_fleet(args: argparse.Namespace) -> Dict[str, Any]:
    """``--fleet fleet.json``: bring up a multi-tenant fleet from a spec
    document and drive the reference's synthetic traffic scenario against
    it -- weighted-fair routing, per-member SLOs, and a mid-run traffic
    shift the autoscaler chases.  The stages sleep their members' service
    times (``fleet.scenario``): the card is not used, as in the
    reference.  Returns the spec, device splits, metrics, attainment,
    audit and autoscaler events; raises unless every member lost and
    misordered nothing."""
    from repro_torch.fleet import FleetSpec
    from repro_torch.fleet.scenario import (FleetScenario, TrafficPhase,
                                            summarize_member)

    with open(args.fleet) as f:
        fspec = FleetSpec.from_json(f.read())
    names = list(fspec.member_names)
    print(f"fleet: {len(names)} members over "
          f"{fspec.pool().n_devices} devices: {names}")

    svc = args.fleet_service_ms / 1e3
    sc = FleetScenario(fspec, {n: svc for n in names})
    fleet = sc.deploy()
    counts0 = fleet.device_counts()
    print(f"pool split: {counts0} (mode={fleet.placement.mode}, "
          f"worst modeled norm {fleet.placement.worst_norm:.2f})")

    # phase 1: share-proportional traffic; phase 2: the first member's
    # load triples (the shift the autoscaler must chase)
    base = {m.name: max(1, round(2 * m.share)) for m in fspec.members}
    shifted = dict(base)
    shifted[names[0]] = 3 * base[names[0]]
    with fleet:
        metrics = sc.drive(fleet, [
            TrafficPhase(windows=args.fleet_windows, rates=base),
            TrafficPhase(windows=args.fleet_windows, rates=shifted),
        ])
        counts1 = fleet.device_counts()
        events = ([] if fleet.autoscaler is None
                  else list(fleet.autoscaler.events))
    att = sc.attainment(metrics)
    for n in names:
        print(f"  {n}: {summarize_member(metrics[n])} "
              f"attainment={att[n]:.2f}")
    audit = sc.audit()
    moves = [e for e in events if e["event"] in ("commit", "rollback")]
    print(f"audit: {audit}")
    print(f"device split {counts0} -> {counts1}; "
          f"{sum(1 for e in moves if e['event'] == 'commit')} committed "
          f"moves, {sum(1 for e in moves if e['event'] == 'rollback')} "
          f"rollbacks")
    if not all(a["lost"] == 0 and a["misordered"] == 0
               for a in audit.values()):
        raise SystemExit(f"fleet lost or misordered requests: {audit}")
    return {"spec": fspec, "counts_before": counts0,
            "counts_after": counts1, "metrics": metrics,
            "attainment": att, "audit": audit, "events": events}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    if args.cards != 1 and (args.backend != "spmd"
                            or args.workload != "batch"):
        raise SystemExit("--cards spreads the SPMD tier's stages over "
                         "cards: it needs --backend spmd and the batch "
                         "workload")
    if args.fleet:
        return run_fleet(args)
    if configs.get(args.arch).config().family not in SERVED_FAMILIES:
        return plan_only(args)
    if args.workload == "decode":
        return main_decode(args)
    if args.backend == "spmd":
        return main_spmd(args)
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
    if "self_heal" in snap:
        heal = snap["self_heal"]
        print(f"self-heal: {heal['windows']} windows, {heal['commits']} "
              f"commits, {heal['rollbacks']} rollbacks "
              f"(state={heal['state']})")
    print(f"pipeline vs direct max err: {res['max_err']:.2e}")
    if not res["max_err"] < 2e-2:
        raise SystemExit(f"pipeline output differs from the direct forward "
                         f"by {res['max_err']:.2e} (bound 2e-2)")
    return res


if __name__ == "__main__":
    main()
