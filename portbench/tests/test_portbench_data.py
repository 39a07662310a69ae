"""The harness finds a cell's configuration, traffic, check and metric
files by the names BENCHMARK.json gives: an added cell needs new files
and entries and no edit to a file that is there."""
import hashlib
import json
import shutil

from portbench import harness

from .cells import RESNET, ROOT


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_an_added_cell_is_found_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(tmp_path / "portbench")
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "resnet50.json").read_text())
    cfg["name"] = "resnet50-wide-batch"
    (pb / "configs" / "resnet50-wide-batch.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "offline-b128.json").read_text())
    mix.update(batch=256, microbatches=8)
    (pb / "traffic" / "offline-b256.json").write_text(json.dumps(mix))
    (pb / "checks" / "resnet50-offline-b256.json").write_text(
        (pb / "checks" / f"{RESNET}.json").read_text())
    (pb / "metrics" / "batches_per_s.images.py").write_text(
        "def read(run):\n    return len(run.batch_s) / run.window_s\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][0],
                             "name": "resnet50-wide-batch",
                             "file": "portbench/configs/"
                                     "resnet50-wide-batch.json"})
    bench["workloads"].append({"name": "resnet50-offline-b256",
                               "config": "resnet50-wide-batch",
                               "traffic": "offline-b256", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({
        "name": "batches_per_s.images", "unit": "1/s", "better": "higher",
        "source": "host_clock", "layer": "whole step",
        "moves": "images_per_s", "workloads": ["resnet50-offline-b256"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.resolve(harness.load_bench(tmp_path),
                           "resnet50-offline-b256", pb)
    assert cell.config["name"] == "resnet50-wide-batch"
    assert cell.traffic["batch"] == 256
    names = [m["name"] for m in cell.metrics]
    assert "batches_per_s.images" in names and "setup_s" in names
    assert "images_per_s" not in names     # listed for another cell
    reader = next(m for m in cell.metrics
                  if m["name"] == "batches_per_s.images")["read"]
    assert reader(harness.Run(cell, 0, 1.0, 2.0, [1.0, 1.0],
                              {"images": 256}, [])) == 1.0
    after = digest(pb)
    assert {k: v for k, v in after.items() if k in before} == before


def test_host_waits_time_the_synchronize_calls_and_put_them_back(
        monkeypatch):
    import time

    import torch

    def wait():
        time.sleep(0.02)

    monkeypatch.setattr(torch.cuda, "synchronize", wait)
    with harness.HostWaits() as waits:
        torch.cuda.synchronize()
        assert torch.cuda.synchronize is not wait
    assert torch.cuda.synchronize is wait
    assert 0.02 <= waits.s < 1.0


def test_host_issue_share_reads_the_unprofiled_batches():
    cell = harness.resolve(harness.load_bench(ROOT), RESNET,
                           ROOT / "portbench")
    reader = next(m for m in cell.metrics
                  if m["name"] == "host_issue_share.images")["read"]
    run = harness.Run(cell, 0, 1.0, 4.0, [1.0, 1.0, 1.0, 1.0],
                      {"images": 128}, [1], wait_s=[0.5, 0.9, 0.25, 0.0])
    assert reader(run) == 1.0 - 0.75 / 3.0
    run.wait_s = []          # an untraced run reads nothing
    assert reader(run) is None
