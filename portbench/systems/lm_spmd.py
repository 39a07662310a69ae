"""A dense or MoE decoder's prefill through the SPMD tier over several
cards.

The configuration's ``model`` is the port's ``LMConfig``.  The front door
plans its layer graph at the mix's sequence length, priced for one card's
memory (``EdgeTPUSpec(onchip_bytes=<card bytes>)``), and
``Deployment.executor(backend="spmd")`` lowers the plan onto
``default_stage_mesh(S, "cuda", cards=k)``.  The weights, bf16 as served
(the router fp32), are made by the reference module from the seed on the
first card a block at a time and kept on the host, since no card holds
the model; the executor streams them to the cards and runs fp32
activations on them made fp32.  A batch is one call ``ex(tokens)``; its
outputs are fp32 logits (B, S, V) on the last card.

The comparison, once the program's state is freed: the reference's fp32
logits of each compared batch, made again from the seed block by block on
the last card.  Each token's error is the widest gap of its logits from
the reference's, as a share of the batch's largest reference logit.  A
top-k choice that float32's rounding breaks the other way on a near tie
sends a token to another expert: that token, and through attention and
the experts' capacity the later tokens of its prompt, move by up to a
tenth of the scale (float64's logits in the program's place show the
same).  So the numbers compared are the median token error, which a
lower precision moves with every token, and the largest of the prompts'
least token errors: causal attention leaves the tokens before a prompt's
first broken tie where they were, while a prompt, a stage or a hop gone
wrong moves every token of a prompt.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import time
from typing import Dict, List

import torch

from repro_torch.api import DeploymentSpec, deploy
from repro_torch.core.edge_tpu_model import EdgeTPUSpec
from repro_torch.launch import pipeline_spmd
from repro_torch.models import lm, lm_graph

from .. import traffic
from ..reference.numerics import precision

# the memory the plan is priced for where the executor runs on the CPU
# (the tests' small cells): every stage fits
CPU_CARD_BYTES = 10 ** 9


def lm_config(model: Dict) -> lm.LMConfig:
    """The port's ``LMConfig`` of the configuration's ``model``."""
    fields = {k: v for k, v in model.items() if k in {
        f.name for f in lm.LMConfig.__dataclass_fields__.values()}}
    fields["dtype"] = getattr(torch, model["dtype"])
    return lm.LMConfig(**fields).validate()


def host_params(reference, model: Dict, seed: int, devices) -> Dict:
    """The weights, made block by block on ``devices`` (a thread a
    device, each making its share of the blocks and copying them to the
    host while the others do) and kept on the host.  A block's numbers do
    not depend on the card that makes it."""
    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        return tree.cpu()

    def make(dev) -> Dict[int, Dict]:
        with torch.cuda.device(dev) if dev.type == "cuda" else (
                contextlib.nullcontext()):
            return {layer: host(reference.make_block(model, seed, layer,
                                                     dev))
                    for layer in range(n) if layer % len(devices)
                    == devices.index(dev)}

    n = model["n_layers"]
    with concurrent.futures.ThreadPoolExecutor(len(devices)) as pool:
        made = [f.result() for f in [pool.submit(make, d) for d in devices]]
    outer = host(reference.make_outer(model, seed, devices[0]))
    blocks = {layer: b for part in made for layer, b in part.items()}
    return {**outer, "blocks": [blocks[layer] for layer in range(n)]}


class LmSpmd:
    def __init__(self, config: Dict, mix: Dict, seed: int, device,
                 reference):
        model, plan = config["model"], config["plan"]
        self.model, self.seed = model, seed
        self.reference = reference
        device = torch.device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = lm_config(model)
        on_card = device.type == "cuda"
        if on_card:
            mesh = pipeline_spmd.default_stage_mesh(
                plan["stages"], "cuda", cards=plan["cards"])
            card_bytes = torch.cuda.get_device_properties(0).total_memory
            first = torch.device("cuda", 0)
        else:
            mesh = pipeline_spmd.default_stage_mesh(plan["stages"], "cpu")
            card_bytes = CPU_CARD_BYTES
            first = device
        self.card_indices = sorted({d.index for d in mesh.cards}
                                   ) if on_card else []
        self.last = mesh.devices[-1]
        dep = deploy(DeploymentSpec(stages=plan["stages"],
                                    strategy=plan["strategy"],
                                    backend="spmd"),
                     graph=lm_graph.lm_layer_graph(cfg, seq_len=mix["seq"]),
                     base_spec=EdgeTPUSpec(onchip_bytes=card_bytes))
        t0 = time.perf_counter()
        params = host_params(reference, model, seed,
                             list(mesh.cards) if on_card else [first])
        t1 = time.perf_counter()
        self.ex = dep.executor(model=cfg, params=params, mesh=mesh,
                               n_microbatches=mix["microbatches"],
                               batch_size=mix["batch"], seq_len=mix["seq"])
        t2 = time.perf_counter()
        del params, dep
        gc.collect()
        self.batches = traffic.pool(mix, model, seed, first)
        t3 = time.perf_counter()
        for i in range(mix["warmup_batches"]):
            self.call(i)
            self.sync()
        self.setup_phases = {"weights_s": t1 - t0, "executor_s": t2 - t1,
                             "warmup_s": time.perf_counter() - t3}

    def call(self, i: int) -> torch.Tensor:
        return self.ex(traffic.pick(self.batches, i))

    def keep(self, out: torch.Tensor) -> torch.Tensor:
        """What a compared batch keeps: its logits, as returned."""
        return out

    def sync(self) -> None:
        for c in self.card_indices:
            torch.cuda.synchronize(c)

    def probes(self) -> Dict:
        """The fill, and each stage timed alone on its card after the
        window."""
        return {"fill_s": self.ex.fill_s,
                "achieved_stage_s": self.ex.achieved_stage_times(),
                "n_stages": self.ex.plan.n_stages,
                "n_microbatches": self.ex.n_microbatches}

    def release(self) -> None:
        self.ex.close()
        self.ex = None
        gc.collect()
        for c in self.card_indices:
            with torch.cuda.device(c):
                torch.cuda.empty_cache()

    def check(self, kept: Dict[int, torch.Tensor], check: Dict
              ) -> Dict[str, float]:
        return compare(self.reference, self.model, self.seed, self.last,
                       self.batches, kept, check)


def token_errors(reference, model: Dict, seed: int, device,
                 tokens: torch.Tensor, got: torch.Tensor) -> torch.Tensor:
    """Each token's widest logit gap from the fp32 reference's, as a share
    of the batch's largest reference logit: (B * S,)."""
    gaps: List[torch.Tensor] = []
    scale = torch.zeros((), device=device)
    rows = reference.logits_rows(model, seed, tokens, device, "fp32")
    for r, ref in enumerate(rows):
        gaps.append((got[r].to(device) - ref).abs().amax(dim=-1))
        scale = torch.maximum(scale, ref.abs().max())
    return torch.cat(gaps) / scale


def compare(reference, model: Dict, seed: int, device, batches,
            kept: Dict[int, torch.Tensor], check: Dict) -> Dict[str, float]:
    """Compared: ``tok_err_median``, the median token error over the
    compared batches, and ``row_err_min_max``, the largest of the prompts'
    least token errors.  Beside them: the largest of the prompts' median
    token errors, the share of tokens whose error passes ``tau``, and the
    largest token error."""
    errs = []
    with torch.no_grad(), precision("fp32"):
        for i, got in sorted(kept.items()):
            errs.append(token_errors(reference, model, seed, device,
                                     traffic.pick(batches, i), got))
    err = torch.cat(errs)
    rows = err.view(-1, next(iter(kept.values())).shape[1])
    return {"tok_err_median": float(err.median()),
            "row_err_min_max": float(rows.min(dim=1).values.max()),
            "row_err_median_max": float(rows.median(dim=1).values.max()),
            "share_over_tau": float((err > check["tau"]).float().mean()),
            "tok_err_max": float(err.max())}


def control(reference, model: Dict, seed: int, device, batches,
            indices, check) -> Dict[int, torch.Tensor]:
    """The control: the reference in TF32 in the program's place (its
    logits of each batch, on ``device``)."""
    with torch.no_grad(), precision("tf32"):
        return {i: torch.stack(list(reference.logits_rows(
            model, seed, traffic.pick(batches, i), device, "tf32")))
            for i in indices}


def build(config, mix, seed, device, reference) -> LmSpmd:
    return LmSpmd(config, mix, seed, device, reference)
