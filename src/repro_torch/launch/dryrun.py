"""The dry-run cell table: for each (arch x shape x grid) cell, the fields
of ``repro/launch/dryrun.py``'s record, on H100 grids::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 1x1
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --no-count
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k --mesh 16x16 --out build/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k --batch 8 --seq 1024   # counted at a reduced shape
    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k \\
        --measure --batch 8 --seq 1024          # on the card

No card is needed for the table: the state is built on the ``meta``
device (``launch/steps.py``'s ``train_state_shapes`` and
``cache_shapes``), and a grid is plain integers (``launch/mesh.py``).  A
record holds the reference's analytic fields: ``state_bytes_per_device``
(the train, prefill or decode state under ``launch/sharding.py``'s
rules), ``activation_bytes_per_device`` (the reference's activation
model), ``device_bytes`` and ``fits_hbm`` against one H100's 80 GB,
``model_flops_global`` and ``compute_s`` at the H100's bf16 peak.

The reference reads its other fields from XLA's compiled program.  Their
counterparts here are counted (:func:`count_cell`): on the ``1x1`` grid
the cell's step runs on the ``meta`` device under
``launch/op_analysis.py``, every aten op and every hand kernel's cost
counted:

==================================  =====================================
reference field                     port field
==================================  =====================================
``lower_s``                         ``count_s`` (build the meta state and
                                    count the step)
``hlo_flops_per_device``            ``counted_flops_per_device``
``hlo_flops_raw_cost_analysis``     ``aten_flops_per_device`` (without
                                    the hand kernels)
``hlo_bytes_per_device``            ``counted_bytes_per_device`` (eager
                                    traffic, one launch an op)
(none)                              ``kernels`` (each hand kernel's
                                    launches, FLOPs and bytes)
``collective_*``                    0, and zeros over the five kinds
``roofline``                        compute, memory and collective terms
                                    at 989e12 FLOP/s and 3.35e12 B/s
``useful_flops_ratio``              ``model_flops_global`` over the
                                    counted FLOPs of every device
==================================  =====================================

On ``16x16`` and ``2x16x16`` the counted fields are None (``counted``
says why): the reference's per-device numbers come from XLA's SPMD
partitioner, and one card runs no partitioned program.  ``count=False``
(``--no-count``) leaves them None too; counting the 32 cells of ``--all``
takes a few minutes of one CPU core.

``compile_s`` and ``memory_analysis_raw`` are measured, on the card
(:func:`measure_cell`, ``--measure``): the cell's step at a reduced shape,
timed, profiled and counted again on the card (module ``launch/
profile_serve.py``'s ``summarize``); it refuses to run without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time
import traceback
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .. import configs
from ..configs.common import SHAPES, ShapeSpec, concrete_batch, input_specs
from ..models import api
from ..models.lm import LMConfig
from ..optim import AdamWConfig
from . import op_analysis
from . import sharding as shd
from . import steps as steps_lib
from . import train as train_lib
from .mesh import (GRIDS, HBM_BW, HBM_BYTES, PEAK_FLOPS_BF16, Grid,
                   data_parallel_size, model_axis_size)

# the counted fields of a record, None where a cell is not counted
COUNTED_FIELDS = ("count_s", "counted_flops_per_device",
                  "aten_flops_per_device", "counted_bytes_per_device",
                  "kernels", "collective_bytes_per_device",
                  "collective_breakdown", "collective_counts", "roofline",
                  "useful_flops_ratio")
NOT_PARTITIONED = ("not counted: the reference's per-device numbers come "
                   "from XLA's SPMD partitioner; one card runs no "
                   "partitioned program, and a one-device count divided "
                   "would restate the 1x1 row")
NOT_COUNTED = "not counted (count=False, --no-count)"
MEASURE_STEPS = 5       # timed steps of a measured cell, after 1 warm-up


def analytic_state_bytes(placed, grid: Grid) -> float:
    """Per-device bytes of the state's leaves (``launch/sharding.py``'s
    ``Placed``): each leaf's bytes over the product of the sizes of the
    axes its spec names."""
    total = 0.0
    for _, leaf, spec in placed:
        denom = 1
        for entry in spec:
            for axis in (entry if isinstance(entry, tuple)
                         else () if entry is None else (entry,)):
                denom *= grid.shape[axis]
        total += float(leaf.numel() * leaf.element_size()) / denom
    return total


def analytic_activation_bytes(cfg: LMConfig, spec: ShapeSpec,
                              grid: Grid) -> float:
    """Per-device activation working set, the reference's model: remat
    residual stack + transients + logits shard + attention score chunk."""
    dp = data_parallel_size(grid)
    tp = model_axis_size(grid)
    b = spec.global_batch
    b_loc = b / dp if b % dp == 0 else b
    s = spec.seq_len if spec.kind != "decode" else 1
    d = cfg.d_model
    v_loc = cfg.vocab / tp if cfg.vocab % tp == 0 else cfg.vocab
    h_loc = max(1, cfg.n_heads / tp)
    act = 0.0
    f_loc = cfg.d_ff / tp if cfg.d_ff % tp == 0 else cfg.d_ff
    if cfg.family == "moe":
        e_loc = max(1, cfg.n_experts / tp)
        f_loc = f_loc * e_loc * 3          # dispatch keeps E_loc expert bufs
    if spec.kind == "train":
        # remat carry stack is sequence-sharded over `model` when divisible
        s_stack = s / tp if (cfg.seq_shard_acts and s % tp == 0) else s
        act += cfg.n_layers * b_loc * s_stack * d * 2  # remat carry stack
        # in-block transients: 2 bf16 full-seq residual copies + gated MLP
        # hidden shards + 2 fp32 seq-sharded norm buffers
        act += 2 * b_loc * s * d * 2
        act += 2 * b_loc * s * f_loc * 2
        act += 2 * b_loc * s_stack * d * 4
        act += 2 * b_loc * 512 * v_loc * 4             # chunked-loss logits
        act += 2 * b_loc * h_loc * min(s, cfg.q_chunk) * s * 4   # scores
    elif spec.kind == "prefill":
        act += 3 * b_loc * s * d * 2 + b_loc * s * f_loc * 2
        act += b_loc * h_loc * min(s, cfg.q_chunk) * s * 4
        act += b_loc * v_loc * 4                       # last-token logits
    else:
        act += 4 * b_loc * d * 4 + b_loc * v_loc * 4
    return act


def cfg_model_flops(cfg: LMConfig, spec: ShapeSpec) -> float:
    """'Useful' FLOPs: 6*N_active*tokens (train) / 2*N_active*tokens
    (prefill; decode: one new token a row)."""
    n = api.active_param_count(cfg)
    if spec.kind == "train":
        return 6.0 * n * (spec.global_batch * spec.seq_len)
    if spec.kind == "prefill":
        return 2.0 * n * (spec.global_batch * spec.seq_len)
    return 2.0 * n * (spec.global_batch * 1)


def model_flops(arch: str, shape_name: str) -> float:
    return cfg_model_flops(configs.get(arch).config(), SHAPES[shape_name])


def state_specs(cfg: LMConfig, spec: ShapeSpec, grid: Grid):
    """The cell's state with its specs, as the reference's dry-run shards
    it: train, the parameters (``fsdp``) and AdamW's state;
    prefill, the parameters; decode, the parameters and the cache of
    ``seq_len`` (sequence-sharded for the attention families)."""
    if spec.kind == "train":
        params, opt = steps_lib.train_state_shapes(cfg)
        return (shd.param_specs(grid, params, fsdp=True)
                + shd.opt_state_specs(grid, opt))
    params = api.init(cfg, "meta")
    placed = shd.param_specs(grid, params)
    if spec.kind == "decode":
        cache = steps_lib.cache_shapes(cfg, spec.global_batch, spec.seq_len)
        mode = "seq" if cfg.family in ("dense", "moe", "vlm") else "hd"
        placed += shd.cache_specs(grid, cache, mode=mode)
    return placed


def cell_step(cfg: LMConfig, spec: ShapeSpec, device="meta"):
    """The cell's step and its inputs on ``device``: (step, args).  On
    ``meta`` the state is ``train_state_shapes`` / ``api.init`` /
    ``cache_shapes`` and the batch ``input_specs``; elsewhere random
    weights (seed 0) and a random batch (numpy seed 0).  train: the train
    step in ``launch/train.py``'s loss chunks, its update written into the
    state where ``steps.donate_update`` says a second state does not fit
    an H100 (``HBM_BYTES``); prefill: the prefill step; decode: one token
    a row into a cache of ``seq_len`` holding ``seq_len - 1`` positions
    (the length a host int, as a live cache's)."""
    meta = torch.device(device).type == "meta"
    gen = None if meta else torch.Generator(device).manual_seed(0)
    text = spec.seq_len - (cfg.n_patches if cfg.family == "vlm" else 0)
    if spec.kind == "train":
        if meta:
            params, opt = steps_lib.train_state_shapes(cfg)
            batch = input_specs(cfg, spec)
        else:
            params, opt = steps_lib.init_train_state(cfg, device, gen)
            batch = _card_batch(cfg, spec, device)
        donate = steps_lib.donate_update(cfg, HBM_BYTES)
        step = steps_lib.make_train_step(
            cfg, AdamWConfig(), train_lib.loss_chunk(cfg, text), donate)
        return step, (params, opt, batch)
    params = api.init(cfg, device, gen)
    if spec.kind == "prefill":
        batch = (input_specs(cfg, spec) if meta
                 else _card_batch(cfg, spec, device))
        return steps_lib.make_prefill_step(cfg), (params, batch)
    if meta:
        cache = steps_lib.cache_shapes(cfg, spec.global_batch, spec.seq_len)
        tokens = input_specs(cfg, spec)["tokens"]
    else:
        cache = api.init_cache(cfg, spec.global_batch, spec.seq_len, device)
        tokens = _card_batch(cfg, spec, device)["tokens"]
    cache = {**cache, "len": spec.seq_len - 1}
    return steps_lib.make_decode_step(cfg), (params, cache, tokens)


def _card_batch(cfg: LMConfig, spec: ShapeSpec, device):
    """A random batch of the cell's shape (numpy seed 0) on ``device``."""
    if spec.kind == "decode":
        rng = np.random.default_rng(0)
        return {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (spec.global_batch, 1))).to(device)}
    batch = concrete_batch(cfg, spec.seq_len, spec.global_batch,
                           rng=np.random.default_rng(0), kind=spec.kind)
    return {k: v.to(device) for k, v in batch.items()}


def count_cell(cfg: LMConfig, spec: ShapeSpec):
    """The cell's step counted on the ``meta`` device ->
    (``op_analysis.CostTotals``, seconds to build the state and count)."""
    t0 = time.perf_counter()
    step, args = cell_step(cfg, spec)
    totals = op_analysis.analyze(step, *args)
    return totals, time.perf_counter() - t0


def counted_fields(totals, seconds: float, model_flops: float,
                   n_devices: int = 1) -> Dict[str, Any]:
    """The record's counted fields of one count (:data:`COUNTED_FIELDS`)."""
    terms = {"compute_s": totals.flops / PEAK_FLOPS_BF16,
             "memory_s": totals.hbm_bytes / HBM_BW, "collective_s": 0.0}
    return {"count_s": seconds,
            "counted_flops_per_device": totals.flops,
            "aten_flops_per_device": totals.aten_flops,
            "counted_bytes_per_device": totals.hbm_bytes,
            "kernels": {k: dict(v) for k, v in totals.kernels.items()},
            "collective_bytes_per_device": totals.coll_bytes,
            "collective_breakdown": dict(totals.coll_by_kind),
            "collective_counts": dict(totals.coll_counts),
            "roofline": dict(terms, dominant=max(terms, key=terms.get)),
            "useful_flops_ratio": (model_flops / (totals.flops * n_devices)
                                   if totals.flops else None)}


def cell_record(cfg: LMConfig, spec: ShapeSpec, grid: Grid,
                count: bool = True) -> Dict[str, Any]:
    """The fields of one cell of ``cfg`` (any depth) at ``spec`` on
    ``grid``: the analytic ones, and on ``1x1`` with ``count`` the
    counted ones (else those None and ``counted`` saying why)."""
    state = analytic_state_bytes(state_specs(cfg, spec, grid), grid)
    act = analytic_activation_bytes(cfg, spec, grid)
    flops = cfg_model_flops(cfg, spec)
    rec = {"status": "ok", "state_bytes_per_device": state,
           "activation_bytes_per_device": act,
           "device_bytes": state + act,
           "fits_hbm": bool(state + act <= HBM_BYTES),
           "model_flops_global": flops,
           "compute_s": flops / (grid.n_devices * PEAK_FLOPS_BF16)}
    if grid.n_devices == 1 and count:
        rec.update(counted_fields(*count_cell(cfg, spec), flops))
        rec["counted"] = "meta"
    else:
        rec.update(dict.fromkeys(COUNTED_FIELDS))
        rec["counted"] = NOT_PARTITIONED if grid.n_devices > 1 else NOT_COUNTED
    return rec


def dryrun_cell(arch: str, shape_name: str, grid: Grid = GRIDS["1x1"],
                verbose: bool = True, count: bool = True) -> Dict[str, Any]:
    """One cell's record (skipped cells: the reason)."""
    mod = configs.get(arch)
    skip = mod.SKIP_SHAPES.get(shape_name)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": grid.name, "n_devices": grid.n_devices}
    if skip:
        rec.update(status="skipped", skip_reason=skip)
        return rec
    rec.update(cell_record(mod.config(), SHAPES[shape_name], grid, count))
    if verbose:
        line = (f"[{rec['mesh']}] {arch} x {shape_name}: "
                f"{rec['device_bytes'] / 2**30:.2f} GiB/dev "
                f"(fits={rec['fits_hbm']}), compute "
                f"{rec['compute_s'] * 1e3:.2f} ms")
        if rec["roofline"] is not None:
            r = rec["roofline"]
            line += (f"; counted in {rec['count_s']:.1f} s: "
                     f"{rec['counted_flops_per_device']:.4e} FLOP, "
                     f"{rec['counted_bytes_per_device']:.4e} B, terms(ms) "
                     f"C={r['compute_s'] * 1e3:.2f} "
                     f"M={r['memory_s'] * 1e3:.2f} -> {r['dominant']}, "
                     f"useful={rec['useful_flops_ratio']:.3f}")
        print(line)
    return rec


# ---------------------------------------------------------------------------
# the measured record (the card)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Reduced:
    """The shape a cell is measured at on one card: rows, sequence (train
    and prefill: tokens a row, the vlm's patches included; decode: the
    cache's length) and layers (None: all)."""
    batch: int
    seq: int
    layers: Optional[int] = None


def reduced_cell(cfg: LMConfig, spec: ShapeSpec, reduced: Reduced):
    """``cfg`` cut to ``reduced.layers`` and the cell's shape at
    ``reduced``'s rows and sequence."""
    if reduced.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=reduced.layers)
    return cfg, ShapeSpec(f"{spec.name} at ({reduced.batch}, "
                          f"{reduced.seq})", reduced.seq, reduced.batch,
                          spec.kind)


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def measure_cell(cfg: LMConfig, spec: ShapeSpec,
                 reduced: Reduced) -> Dict[str, Any]:
    """The cell's step at ``reduced`` on the card: 1 warm-up and
    :data:`MEASURE_STEPS` timed steps (host clock, each ending in a
    synchronize; the train state carried from step to step, its update
    functional or written into the state as ``steps.donate_update``
    says), one step under ``torch.profiler``
    (``profile_serve.summarize``), one more under ``op_analysis`` on the
    card, held op for op against the meta count of the same reduced cell
    (``card_count_equal``; ``launches``: the kernels' launch counts of
    that step).  Raises without a card: it never falls back to the
    CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_cell runs on a CUDA card; torch sees "
                           "none")
    from ..kernels import _build
    from .profile_serve import profiled, summarize
    full_layers = cfg.n_layers
    cfg, rspec = reduced_cell(cfg, spec, reduced)
    meta, count_s = count_cell(cfg, rspec)
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    step, args = cell_step(cfg, rspec, dev)
    torch.cuda.synchronize()
    entry = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    stats0 = torch.cuda.memory_stats()

    def run():
        nonlocal args
        out = step(*args)
        if spec.kind == "train":      # the next step from the new state
            args = (out[0], out[1], args[2])
        return out

    times = []
    for _ in range(MEASURE_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    stats = torch.cuda.memory_stats()
    peak = torch.cuda.max_memory_allocated() - base
    prof, wall = profiled(run)
    window = summarize(prof, wall, f"{cfg.name} x {spec.name}")
    torch.cuda.synchronize()
    _build.reset_launches()
    _, card = op_analysis.counted(run)
    torch.cuda.synchronize()
    launches = {name: _build.launches(name) for name in meta.kernels}
    step_s = float(np.median(times[1:]))
    fields = counted_fields(meta, count_s, cfg_model_flops(cfg, rspec))
    terms = fields["roofline"]
    rec = {
        "arch": cfg.name, "shape": spec.name, "kind": spec.kind,
        "reduced": {"batch": reduced.batch, "seq": reduced.seq,
                    "layers": cfg.n_layers, "cell_batch": spec.global_batch,
                    "cell_seq": spec.seq_len, "cell_layers": full_layers},
        "donated": (spec.kind == "train"
                    and steps_lib.donate_update(cfg, HBM_BYTES)),
        "steps_s": times, "warmup_s": times[0] - step_s, "step_s": step_s,
        "step_s_spread": [float(min(times[1:])), float(max(times[1:]))],
        "memory_stats": {
            "state_bytes_at_entry": entry, "peak_bytes": peak,
            "peak_less_entry_bytes": peak - entry,
            "reserved_peak_bytes": torch.cuda.max_memory_reserved(),
            "alloc_retries": (stats.get("num_alloc_retries", 0)
                              - stats0.get("num_alloc_retries", 0)),
            "ooms": stats.get("num_ooms", 0) - stats0.get("num_ooms", 0)},
        "device": {"wall_s": window["wall_s"], "busy_s": window["busy_s"],
                   "idle_share": (1 - window["busy_s"] / window["wall_s"]
                                  if window["wall_s"] else None),
                   "kernels": window["kernels"],
                   "by_kind_s": window["by_kind_s"]},
        "model_flops": cfg_model_flops(cfg, rspec),
        **fields,
        "card_count_equal": op_analysis.same_count(card, meta),
        "launches": launches,
        "roofline_share": max(terms["compute_s"], terms["memory_s"]) / step_s,
        "peak_share": meta.flops / (step_s * PEAK_FLOPS_BF16),
        "card": nvidia_smi(),
    }
    if not rec["card_count_equal"]:
        rec["count_differs"] = _count_diff(card, meta)
    return rec


def _count_diff(card, meta) -> Dict[str, Any]:
    """The ops and kernels whose card and meta counts differ."""
    out = {}
    for table in ("ops", "kernels"):
        a, b = getattr(card, table), getattr(meta, table)
        for key in sorted(set(a) | set(b)):
            if a.get(key) != b.get(key):
                out[f"{table}:{key}"] = {"card": a.get(key),
                                         "meta": b.get(key)}
    return out


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=sorted(GRIDS), default="1x1")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None,
                    help="also write one JSON record a cell here")
    ap.add_argument("--no-count", action="store_true",
                    help="the analytic fields only (the counted ones None)")
    ap.add_argument("--measure", action="store_true",
                    help="measure --arch x --shape on the card at --batch "
                         "x --seq (and --layers)")
    ap.add_argument("--batch", type=int, default=None,
                    help="count (or --measure) --arch x --shape at these "
                         "rows")
    ap.add_argument("--seq", type=int, default=None,
                    help="... and this sequence (decode: cache length)")
    ap.add_argument("--layers", type=int, default=None,
                    help="... cut to this many layers")
    args = ap.parse_args(argv)

    if args.measure or args.batch or args.seq or args.layers:
        if not (args.arch and args.shape and args.batch and args.seq):
            ap.error("a reduced cell (--measure, --batch, --seq, --layers) "
                     "takes --arch, --shape, --batch and --seq")
        cfg, spec = configs.get(args.arch).config(), SHAPES[args.shape]
        reduced = Reduced(args.batch, args.seq, args.layers)
        if args.measure:
            rec = measure_cell(cfg, spec, reduced)
        else:
            rcfg, rspec = reduced_cell(cfg, spec, reduced)
            rec = {"arch": args.arch, "shape": rspec.name,
                   "layers": rcfg.n_layers,
                   **counted_fields(*count_cell(rcfg, rspec),
                                    cfg_model_flops(rcfg, rspec))}
        print(json.dumps({"measured" if args.measure else "counted": rec}))
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"{args.arch}_{args.shape}_"
                                   f"{args.batch}x{args.seq}.json"),
                      "w") as f:
                json.dump(rec, f, indent=1)
        return [rec]
    if args.all:
        cells = [(aid, sname) for aid, sname, _ in
                 configs.cells(include_skipped=True)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    grid = GRIDS[args.mesh]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    records, failures = [], []
    for arch, shape in cells:
        tag = f"{arch}_{shape}_{grid.name}"
        try:
            rec = dryrun_cell(arch, shape, grid, count=not args.no_count)
        except Exception as e:   # noqa: BLE001 -- record and continue
            rec = {"arch": arch, "shape": shape, "mesh": grid.name,
                   "status": "error", "error": repr(e),
                   "traceback": traceback.format_exc()}
            failures.append(tag)
            print(f"FAILED {tag}: {e}")
        if rec["status"] == "skipped":
            print(f"[{grid.name}] {arch} x {shape}: skipped "
                  f"({rec['skip_reason']})")
        records.append(rec)
        if args.out:
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        raise SystemExit(1)
    print("\nall dry-run cells green")
    return records


if __name__ == "__main__":
    main()
