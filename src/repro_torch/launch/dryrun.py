"""The dry-run cell table: for each (arch x shape x grid) cell, the analytic
fields of ``repro/launch/dryrun.py``'s record, on H100 grids::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 1x1
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k --mesh 16x16 --out build/dryrun

No card is needed: the state is built on the ``meta`` device
(``launch/steps.py``'s ``train_state_shapes`` and ``cache_shapes``), and a
grid is plain integers (``launch/mesh.py``).  A record holds the
reference's analytic fields: ``state_bytes_per_device`` (the train,
prefill or decode state under ``launch/sharding.py``'s rules),
``activation_bytes_per_device`` (the reference's activation model),
``device_bytes`` and ``fits_hbm`` against one H100's 80 GB,
``model_flops_global`` and ``compute_s`` at the H100's bf16 peak.

The reference's fields read from XLA's compiled HLO have no counterpart
here and are left out: ``lower_s``, ``compile_s``,
``memory_analysis_raw``, ``hlo_*``, ``collective_*``, the memory and
collective roofline terms and ``useful_flops_ratio``.
"""
from __future__ import annotations

import argparse
import json
import os
import traceback
from typing import Any, Dict, Optional, Sequence

from .. import configs
from ..configs.common import SHAPES, ShapeSpec
from ..models import api
from ..models.lm import LMConfig
from . import sharding as shd
from . import steps as steps_lib
from .mesh import (GRIDS, HBM_BYTES, PEAK_FLOPS_BF16, Grid,
                   data_parallel_size, model_axis_size)


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


def cell_record(cfg: LMConfig, spec: ShapeSpec, grid: Grid
                ) -> Dict[str, Any]:
    """The analytic fields of one cell of ``cfg`` (any depth) at
    ``spec`` on ``grid``."""
    state = analytic_state_bytes(state_specs(cfg, spec, grid), grid)
    act = analytic_activation_bytes(cfg, spec, grid)
    flops = cfg_model_flops(cfg, spec)
    return {"status": "ok", "state_bytes_per_device": state,
            "activation_bytes_per_device": act,
            "device_bytes": state + act,
            "fits_hbm": bool(state + act <= HBM_BYTES),
            "model_flops_global": flops,
            "compute_s": flops / (grid.n_devices * PEAK_FLOPS_BF16)}


def dryrun_cell(arch: str, shape_name: str, grid: Grid = GRIDS["1x1"],
                verbose: bool = True) -> Dict[str, Any]:
    """One cell's record (skipped cells: the reason)."""
    mod = configs.get(arch)
    skip = mod.SKIP_SHAPES.get(shape_name)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": grid.name, "n_devices": grid.n_devices}
    if skip:
        rec.update(status="skipped", skip_reason=skip)
        return rec
    rec.update(cell_record(mod.config(), SHAPES[shape_name], grid))
    if verbose:
        print(f"[{rec['mesh']}] {arch} x {shape_name}: "
              f"{rec['device_bytes'] / 2**30:.2f} GiB/dev "
              f"(fits={rec['fits_hbm']}), compute "
              f"{rec['compute_s'] * 1e3:.2f} ms")
    return rec


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=sorted(GRIDS), default="1x1")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None,
                    help="also write one JSON record a cell here")
    args = ap.parse_args(argv)

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
            rec = dryrun_cell(arch, shape, grid)
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
