"""A CNN of the paper's zoo through the SPMD tier.

The front door plans the configuration's ``plan`` (``deploy_cnn`` over the
model's own layer graph, the analytic plan), and
``Deployment.executor(backend="spmd")`` lowers it onto one stream a stage
on one card (``default_stage_mesh(S, cards=1)``).  A batch is one call of
the executor, ``ex(x)``, over the mix's microbatches; its outputs are the
output node's (B, classes) activations.

The comparison: every compared batch's outputs against the reference's
forward of the same images and weights, made again from the seed once the
program's state is freed; the number is the widest gap over all of them,
as a share of the batch's largest reference output.
"""
from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from repro_torch.api import DeploymentSpec
from repro_torch.launch import pipeline_spmd, serve
from repro_torch.models import cnn

from .. import traffic
from ..reference.numerics import precision

KEEP_CHUNK = 64         # batches' outputs kept in one allocation


class CnnSpmd:
    def __init__(self, config: Dict, mix: Dict, seed: int, device,
                 reference):
        model, plan = config["model"], config["plan"]
        self.model, self.seed = model, seed
        self.reference = reference
        self.device = torch.device(device)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.net = cnn.REAL_CNNS[model["zoo_name"]]()
        reference.check_names(model, self.net._order)
        params = reference.make_params(model, seed, self.device)
        dep = serve.deploy_cnn(self.net, params, DeploymentSpec(
            model=f"cnn:{model['zoo_name']}", stages=plan["stages"],
            strategy=plan["strategy"], backend="spmd"), self.device)
        on_card = self.device.type == "cuda"
        mesh = pipeline_spmd.default_stage_mesh(
            plan["stages"], self.device, **({"cards": plan["cards"]}
                                            if on_card else {}))
        self.card_indices = sorted({d.index for d in mesh.cards}
                                   ) if on_card else []
        self.ex = dep.executor(model=self.net, params=params, mesh=mesh,
                               n_microbatches=mix["microbatches"],
                               batch_size=mix["batch"])
        del params, dep
        self.batches = traffic.pool(mix, model, seed, self.device)
        self._store, self._slot = torch.empty(0), 0
        t0 = time.perf_counter()
        for i in range(mix["warmup_batches"]):
            self.call(i)
            self.sync()
        self.setup_phases = {"warmup_s": time.perf_counter() - t0}

    def call(self, i: int) -> torch.Tensor:
        return self.ex(traffic.pick(self.batches, i))

    def keep(self, out: torch.Tensor) -> torch.Tensor:
        """What a compared batch keeps: its (B, classes) outputs alone,
        not the boundary buffer they are a view of, copied into a slot of
        storage made ``KEEP_CHUNK`` batches at a time: a fresh allocation
        for every batch grew the allocator inside the window (0.4 to 1.4
        s of 40 s between batches on an H100)."""
        if self._slot == len(self._store):
            self._store = torch.empty((KEEP_CHUNK,) + tuple(out.shape),
                                      dtype=out.dtype, device=out.device)
            self._slot = 0
        self._slot += 1
        return self._store[self._slot - 1].copy_(out)

    def sync(self) -> None:
        for c in self.card_indices:
            torch.cuda.synchronize(c)

    def probes(self) -> Dict:
        """What the traced run's metrics read of the executor after the
        window: nothing on this path."""
        return {}

    def release(self) -> None:
        self.ex.close()
        self.ex = None
        gc.collect()
        if self.card_indices:
            torch.cuda.empty_cache()

    def check(self, kept: Dict[int, torch.Tensor], check: Dict
              ) -> Dict[str, float]:
        return compare(self.reference, self.model, self.seed, self.device,
                       self.batches, kept, check)


def compare(reference, model: Dict, seed: int, device, batches,
            kept: Dict[int, torch.Tensor], check: Dict) -> Dict[str, float]:
    """The widest gap between ``kept`` outputs and the fp32 reference's, as
    a share of the batch's largest reference output, over the batches."""
    params = reference.make_params(model, seed, device)
    worst = 0.0
    with torch.no_grad(), precision("fp32"):
        for i, got in sorted(kept.items()):
            ref = reference.forward_rows(model, params,
                                         traffic.pick(batches, i),
                                         check["rows"])
            gap = (got.to(ref.device) - ref).abs().max()
            worst = max(worst, float(gap / ref.abs().max()))
    return {"max_rel_err": worst}


def control(reference, model: Dict, seed: int, device, batches,
            indices, check) -> Dict[int, torch.Tensor]:
    """The control: the reference in TF32 in the program's place."""
    params = reference.make_params(model, seed, device)
    with torch.no_grad(), precision("tf32"):
        return {i: reference.forward_rows(model, params,
                                          traffic.pick(batches, i),
                                          check["rows"], "tf32")
                for i in indices}


def build(config, mix, seed, device, reference) -> CnnSpmd:
    return CnnSpmd(config, mix, seed, device, reference)
