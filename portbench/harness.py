"""One run of one cell: set-up, the measured window, the comparison with
the reference, the metrics and the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.  The
harness finds, by those names and by each metric's name:

* ``configs/<config>.json`` -- the configuration as it is run; its
  ``system`` names ``systems/<system>.py`` (how the program is deployed
  and driven) and its ``reference`` ``reference/<reference>.py``;
* ``traffic/<traffic>.json`` -- the mix, read by ``traffic.py``;
* ``checks/<workload>.json`` -- the numbers compared with the reference
  and their limits;
* ``metrics/<metric>.py`` -- one reader a metric, ``read(run)`` returning
  a number or None (nothing to read: the metric is left out).

So a later change adds a cell, a configuration, a mix or a metric by
adding files and entries, and edits none.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    workload: Dict
    config: Dict
    traffic: Dict
    check: Dict
    system: ModuleType
    reference: ModuleType
    metrics: List[Dict]          # BENCHMARK.json entries, each with "read"


def load_module(path: Path, name: str) -> ModuleType:
    """The module at ``path``, imported under ``name`` (a metric's file
    name holds dots, so it is loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _file(root: Path, sub: str, name: str) -> Path:
    path = root / sub / name
    if not path.is_file():
        raise FileNotFoundError(f"{path} (named in BENCHMARK.json)")
    return path


def resolve(bench: Dict, workload: str, root: Path = HERE) -> Cell:
    """Everything one cell needs, found by name under ``root`` (the
    benchmark's folder)."""
    from . import traffic as traffic_mod
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"({sorted(cells)})")
    w = cells[workload]
    cfgs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root.parent / cfgs[w["config"]]["file"])
                        .read_text())
    mix = traffic_mod.load(_file(root, "traffic", f"{w['traffic']}.json"))
    check = json.loads(_file(root, "checks", f"{workload}.json").read_text())
    system = load_module(_file(root, "systems", f"{config['system']}.py"),
                         f"portbench.systems.{config['system']}")
    reference = load_module(
        _file(root, "reference", f"{config['reference']}.py"),
        f"portbench.reference.{config['reference']}")
    metrics = []
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if "workloads" in m and workload not in m["workloads"]:
                continue
            mod = load_module(_file(root, "metrics", f"{m['name']}.py"),
                              f"portbench.metrics.{m['name']}")
            metrics.append({**m, "kind": kind, "read": mod.read})
    return Cell(w, config, mix, check, system, reference, metrics)


def process_age_s() -> Optional[float]:
    """Seconds since this process started (its start time in
    ``/proc/self/stat`` against the boot clock), or None off Linux."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's,
    flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    cell: Cell
    seed: int
    setup_s: float
    window_s: float
    batch_s: List[float]           # each batch, issue to synchronise
    units: Dict[str, int]          # what one batch completes
    traced: List[int]              # the profiled batches' indices
    trace: Any = None              # trace.Trace of the profiled batches
    probes: Dict[str, Any] = dataclasses.field(default_factory=dict)
    peaks: Dict[str, float] = dataclasses.field(default_factory=dict)
    # each batch's host seconds in CUDA synchronize calls (traced run)
    wait_s: List[float] = dataclasses.field(default_factory=list)

    def rate(self, unit: str, untraced: bool = False) -> float:
        """``unit``s completed a second over the window; ``untraced``:
        over the batches that were not profiled and their time."""
        if not untraced:
            return len(self.batch_s) * self.units[unit] / self.window_s
        keep = [t for i, t in enumerate(self.batch_s)
                if i not in self.traced]
        return len(keep) * self.units[unit] / sum(keep)


class HostWaits:
    """Host seconds spent waiting in CUDA synchronize calls -- a stream's,
    an event's or a device's -- on the host clock, while entered: torch's
    three calls are wrapped with a timer, and put back on exit.  The
    profiler is not needed, so the batches it does not trace are read
    as they run."""

    CALLS = (("Stream", "synchronize"), ("Event", "synchronize"),
             (None, "synchronize"))

    def __init__(self):
        self.s = 0.0
        self.saved: List[Any] = []

    def _timed(self, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.s += time.perf_counter() - t
        return timed

    def __enter__(self) -> "HostWaits":
        import torch
        for cls, name in self.CALLS:
            owner = torch.cuda if cls is None else getattr(torch.cuda, cls)
            fn = getattr(owner, name)
            self.saved.append((owner, name, fn))
            setattr(owner, name, self._timed(fn))
        return self

    def __exit__(self, *exc) -> None:
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)
        self.saved = []


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> Dict:
    """One run; returns the result object (without the import check)."""
    import torch
    from . import arith, traffic
    from .trace import Trace
    t0 = time.perf_counter()
    mix = cell.traffic
    sut = cell.system.build(cell.config, mix, seed, device, cell.reference)
    sample = traffic.CheckSample(mix, seed)
    age = process_age_s()
    setup_s = age if age is not None else time.perf_counter() - t0
    traced = (list(range(mix["trace_from"],
                         mix["trace_from"] + mix["trace_batches"]))
              if trace else [])
    prof, trace_wall = None, 0.0
    batch_s, wait_s, kept = [], [], {}
    waits = HostWaits()
    if trace:
        waits.__enter__()
    start = time.perf_counter()
    deadline = start + seconds
    i = 0
    while True:
        if traced and i == traced[0]:
            tx = time.perf_counter()
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            tp = time.perf_counter()
            # the profiler's start is no part of the window
            deadline += tp - tx
            start += tp - tx
        w0 = waits.s
        ts = time.perf_counter()
        out = sut.call(i)
        sut.sync()
        te = time.perf_counter()
        batch_s.append(te - ts)
        wait_s.append(waits.s - w0)
        kept[i] = sut.keep(out)
        sample.release(kept, i)
        del out
        if traced and i == traced[-1]:
            trace_wall = time.perf_counter() - tp
            tx = time.perf_counter()
            prof.__exit__(None, None, None)
            # the profiler's own processing is no part of the window
            paused = time.perf_counter() - tx
            deadline += paused
            start += paused
        i += 1
        if te >= deadline and (not traced or i > traced[-1]):
            break
    window_s = te - start
    waits.__exit__(None, None, None)
    peak = max(torch.cuda.max_memory_allocated(d) for d in sut.card_indices
               ) if device == "cuda" else 0
    run = Run(cell, seed, setup_s, window_s, batch_s, traffic.units(mix),
              traced, wait_s=wait_s if trace else [])
    if device == "cuda":
        name = torch.cuda.get_device_name(sut.card_indices[0])
        run.peaks = arith.peaks(name)
    else:
        name = "cpu"
        run.peaks = arith.peaks()
    if prof is not None:
        run.trace = Trace(prof, trace_wall, sut.card_indices)
        del prof
        run.probes = sut.probes()
    done = len(batch_s)
    chosen = sample.chosen(done)
    kept = {j: kept[j] for j in chosen}
    sut.release()
    numbers = sut.check(kept, cell.check)
    checks = {key: {"value": numbers[key], "limit": c["limit"]}
              for key, c in cell.check["numbers"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in cell.metrics:
        if (m["kind"] == "per_layer") != bool(trace):
            continue
        value = m["read"](run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    items = done * mix["batch"]
    result = {"correct": correct, "attempted": items, "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else device,
                         "kind": name, "count": len(sut.card_indices),
                         "memory_peak_bytes": peak}}
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.mean_busy_s()
        result["device"]["window_s"] = run.trace.wall_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["window"] = {"batches": done, "seconds": window_s,
                        "first_batch_s": batch_s[0],
                        "median_batch_s": sorted(batch_s)[done // 2],
                        "max_batch_s": max(batch_s),
                        "between_batches_s": window_s - sum(batch_s)}
    result["setup"] = getattr(sut, "setup_phases", {})
    result["checked"] = {"batches": chosen, "of": done, "readings": {
        k: v for k, v in numbers.items() if k not in checks}}
    result["checks"] = checks
    return result


def load_bench(root: Path) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="One run of one cell of "
                                 "BENCHMARK.json on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, root: Path = HERE.parent) -> int:
    args = parse_args(argv)
    bench = load_bench(root)
    cell = resolve(bench, args.workload, root / HERE.name)
    import torch
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); this process "
              f"sees {seen}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found} (the harness and the port "
              f"load none of them)", file=sys.stderr)
        return 3
    for key, c in result["checks"].items():
        print(f"check {key}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
