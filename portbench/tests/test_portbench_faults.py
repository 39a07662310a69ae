"""A whole run of each cell on the CPU at a small size, without the look
for a card: sound, it comes out correct; with the timed path broken
underneath (a hop between stages that hands on zeros, half of each batch
left out, one answer swapped with another where the executor returns it)
or with the reference in TF32 in the program's place (the control), it
does not."""
import pytest
import torch

from portbench import control, harness
from repro_torch.launch import pipeline_spmd

from .cells import PHI, RESNET, small

SEED = 2 ** 31 + 1234


def zero_hop(x, done, device, stream):
    return torch.zeros_like(x, device=device)


def half_batch(call):
    def run(self, batch):
        out = call(self, batch).clone()
        out[out.shape[0] // 2:] = 0
        return out
    return run


def swapped_answer(call):
    def run(self, batch):
        out = call(self, batch).clone()
        out[[0, 1]] = out[[1, 0]]
        return out
    return run


def run(workload):
    return harness.run_cell(small(workload), SEED, 0.2, False,
                            device="cpu")


@pytest.mark.parametrize("workload", [RESNET, PHI])
def test_a_sound_run_is_correct(workload):
    res = run(workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload", [RESNET, PHI])
@pytest.mark.parametrize("fault", ["zero_hop", "half_batch",
                                   "swapped_answer"])
def test_a_broken_path_is_not_correct(workload, fault, monkeypatch):
    if fault == "zero_hop":
        monkeypatch.setattr(pipeline_spmd, "_hop", zero_hop)
    else:
        wrap = {"half_batch": half_batch,
                "swapped_answer": swapped_answer}[fault]
        cls = pipeline_spmd.SpmdPipelineExecutor
        monkeypatch.setattr(cls, "__call__", wrap(cls.__call__))
    res = run(workload)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", [RESNET, PHI])
def test_the_control_is_not_correct(workload):
    cell = small(workload)
    numbers = control.control_numbers(cell, SEED, "cpu")
    limits = {k: v["limit"] for k, v in cell.check["numbers"].items()}
    assert any(numbers[k] > limits[k] for k in limits), numbers
