"""The control of a cell's comparison: the reference computed in the
nearest precision below the configuration's (TF32 for float32 with TF32
off) put in the program's place, through the same comparison as a run.
Its numbers are the upper readings the limits in ``checks/`` lie below;
the program's runs give the lower ones.

    python3 portbench/control.py --workload resnet50-offline-b128 \
        --seeds 11,12,13

Runs on the first card at the cell's own sizes and prints one JSON line a
seed.  The benchmark's runs do not run it.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(cell, seed: int, device: str = "cuda") -> dict:
    """The cell's compared numbers with the TF32 reference's outputs in
    the program's place, over the batches a run compares (distinct ones
    of the pool)."""
    from portbench import traffic
    mix, model = cell.traffic, cell.config["model"]
    first = "cuda:0" if device == "cuda" else device
    batches = traffic.pool(mix, model, seed, first)
    n = min(mix["pool"], int(mix["check"]["batches"])
            + int(bool(mix["check"].get("last"))))
    kept = cell.system.control(cell.reference, model, seed, first, batches,
                               list(range(n)), cell.check)
    return cell.system.compare(cell.reference, model, seed, first, batches,
                               kept, cell.check)


def main(argv=None) -> int:
    import argparse
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import harness
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = harness.resolve(harness.load_bench(ROOT), args.workload,
                           ROOT / "portbench")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers = control_numbers(cell, seed)
        limits = {k: v["limit"] for k, v in cell.check["numbers"].items()}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": numbers, "limits": limits,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
