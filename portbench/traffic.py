"""The one traffic generator: it reads a mix's file of parameters
(``traffic/<name>.json``) and makes the batches a run sends.

Every mix so far is a closed loop with one batch in flight: the next batch
is issued once the last one's outputs are on the device and synchronised.
A run cycles through a pool of ``pool`` distinct batches, made on the
device from the seed at set-up, so every seed sends the same sizes in the
same order and only the numbers differ.

Keys of a mix:

* ``loop`` -- ``"closed"`` (the only loop so far), ``in_flight`` -- 1.
* ``input`` -- ``"images"``: standard normal (batch, H, W, C) fp32 images,
  H, W, C the configuration's ``input_shape``; ``"tokens"``: (batch,
  ``seq``) ids uniform over the configuration's ``vocab``.
* ``batch``, ``microbatches`` -- items a batch and the executor's
  microbatches a batch.
* ``pool`` -- distinct batches made at set-up.
* ``warmup_batches`` -- batches run before the window, as set-up.
* ``trace_from``, ``trace_batches`` -- the batches of the window a traced
  run profiles.
* ``check`` -- which outputs are compared with the reference: ``batches``
  of them, drawn from the seed among all batches of the window (every
  output kept), or with ``within`` among its first ``within`` (those and
  the latest kept), and with ``last`` the window's last batch too.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

KEYS = ("loop", "in_flight", "input", "batch", "microbatches", "pool",
        "warmup_batches", "trace_from", "trace_batches", "check")


def load(path: Path) -> Dict:
    mix = json.loads(Path(path).read_text())
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise ValueError(f"{path}: traffic keys {missing} missing")
    if mix["loop"] != "closed" or mix["in_flight"] != 1:
        raise ValueError(f"{path}: only a closed loop with one batch in "
                         f"flight is generated")
    if mix["batch"] % mix["microbatches"]:
        raise ValueError(f"{path}: batch {mix['batch']} is not a multiple "
                         f"of {mix['microbatches']} microbatches")
    return mix


def _gen_seed(seed: int, tag: int) -> int:
    return (int(seed) * 0x2545F491 + tag * 7919) % (2 ** 63)


def pool(mix: Dict, model: Dict, seed: int, device) -> List[torch.Tensor]:
    """The ``pool`` distinct batches of the mix, made on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(_gen_seed(seed, 3))
    n, b = mix["pool"], mix["batch"]
    if mix["input"] == "images":
        shape = (b,) + tuple(model["input_shape"])
        return [torch.randn(shape, generator=gen, device=device)
                for _ in range(n)]
    if mix["input"] == "tokens":
        return [torch.randint(0, model["vocab"], (b, mix["seq"]),
                              generator=gen, device=device)
                for _ in range(n)]
    raise ValueError(f"traffic input {mix['input']!r}")


def units(mix: Dict) -> Dict[str, int]:
    """What one batch completes, by unit."""
    if mix["input"] == "images":
        return {"images": mix["batch"]}
    return {"prompts": mix["batch"], "tokens": mix["batch"] * mix["seq"]}


class CheckSample:
    """Which of a window's batches are compared with the reference, drawn
    from the seed."""

    def __init__(self, mix: Dict, seed: int):
        c = mix["check"]
        self.n = int(c["batches"])
        self.within = c.get("within")
        self.last = bool(c.get("last", False))
        self.rng = np.random.default_rng([int(seed) % (2 ** 63), 11])
        self.drawn = (sorted(self.rng.choice(self.within, self.n,
                                             replace=False).tolist())
                      if self.within else None)

    def chosen(self, done: int) -> List[int]:
        """The batches compared, once ``done`` batches have completed (the
        latest where no drawn one completed)."""
        if self.drawn is None:
            picked = self.rng.choice(done, min(self.n, done), replace=False)
            return sorted(int(i) for i in picked)
        out = [i for i in self.drawn if i < done]
        if (self.last or not out) and done - 1 not in out:
            out.append(done - 1)
        return out

    def release(self, kept: Dict[int, object], i: int) -> None:
        """Drop the kept outputs before batch ``i`` that will not be
        compared (drawn ``within``: all but the drawn ones)."""
        if self.drawn is not None:
            for j in [j for j in kept if j < i and j not in self.drawn]:
                del kept[j]


def pick(batches: Sequence[torch.Tensor], i: int) -> torch.Tensor:
    return batches[i % len(batches)]
