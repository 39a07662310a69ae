"""The benchmark's cells cut to sizes a CPU test runs in a second or two:
ResNet50 at its published input on two to four images, the phi3.5-moe
cell at the port's smoke widths with capacity that drops tokens.

The phi3.5-moe cell waits outside ``BENCHMARK.json`` for a steadier
set-up of the program (``PERF.md`` §7); its files stay under
``portbench/``, and these tests add its entries to a copy of the
benchmark to keep them sound."""
import copy
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
RESNET = "resnet50-offline-b128"
PHI = "phi35moe-prefill-4card"
PHI_ENTRIES = {
    "configs": {"name": "phi35moe-42b",
                "source": "https://huggingface.co/microsoft/"
                          "Phi-3.5-MoE-instruct",
                "file": "portbench/configs/phi35moe-42b.json",
                "reduced": [], "why": "sparse experts over four cards"},
    "workloads": {"name": PHI, "config": "phi35moe-42b",
                  "traffic": "prefill-16x1024-m8", "chips": 4,
                  "why": "prefill over four cards"},
}
SMALL_MOE = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                 head_dim=16, d_ff=128, vocab=512, n_experts=4,
                 moe_group=16)


def with_phi(bench):
    """``bench`` with the phi3.5-moe cell's entries added."""
    bench = copy.deepcopy(bench)
    for key, entry in PHI_ENTRIES.items():
        if entry["name"] not in {e["name"] for e in bench[key]}:
            bench[key].append(dict(entry))
    return bench


def small(workload: str, bench=None) -> harness.Cell:
    cell = harness.resolve(with_phi(bench or harness.load_bench(ROOT)),
                           workload, ROOT / "portbench")
    if workload == RESNET:
        cell.traffic.update(batch=4, microbatches=2, pool=2,
                            warmup_batches=0, check={"batches": 2})
        cell.check["rows"] = 4
    else:
        cell.config["model"].update(SMALL_MOE)
        cell.traffic.update(seq=32, batch=4, microbatches=2, pool=2,
                            warmup_batches=0)
    return cell
