"""Training driver: the fault-tolerant loop over the step builders, as
``repro/launch/train.py``, on the card unless ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --steps 60 --ckpt-dir /tmp/ckpt --fail-at 25 [--device cpu]

Data are addressed by step (``SyntheticLMDataset.batch_at``; vlm and
encdec batches from ``configs.common.concrete_batch`` with the step as the
numpy seed), so a restart from a checkpoint replays the same batches.
The loss runs in chunks of :func:`loss_chunk`, a divisor of the trained
sequence (the reference's ``min(512, seq)`` does not divide the vlm's
``seq + n_patches``, and its ``chunked_lm_loss`` asserts).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import configs, resolve_device
from ..checkpoint import CheckpointStore
from ..configs.common import concrete_batch
from ..data import DataConfig, SyntheticLMDataset
from ..models.lm import LMConfig
from ..optim import AdamWConfig
from ..runtime import FailureInjector, TrainSupervisor
from . import steps as steps_lib


# the smallest loss chunk a length may take: below it a step runs so many
# checkpointed chunks that the length is refused instead
MIN_LOSS_CHUNK = 64


def loss_chunk(cfg: LMConfig, seq: int) -> int:
    """The largest divisor not above 512 of the sequence a step of ``seq``
    text tokens trains on: ``seq + n_patches`` for the vlm family (its
    batch puts the patches first), ``seq`` for the others.  Raises
    ValueError where that divisor is below MIN_LOSS_CHUNK (a length above
    512 with no such divisor, e.g. a prime)."""
    n = seq + cfg.n_patches if cfg.family == "vlm" else seq
    chunk = max(c for c in range(1, min(512, n) + 1) if n % c == 0)
    if chunk < min(MIN_LOSS_CHUNK, n):
        raise ValueError(f"a trained sequence of {n} tokens has no divisor "
                         f"from {MIN_LOSS_CHUNK} to 512 to chunk its loss "
                         f"by (the largest is {chunk}); choose another "
                         f"--seq")
    return chunk


def step_batch(cfg: LMConfig, data: SyntheticLMDataset, step: int,
               batch: int, seq: int, device) -> Dict[str, torch.Tensor]:
    """The batch of ``step`` on ``device``: the dataset's tokens and
    labels; vlm: the whole batch from ``concrete_batch`` (seq text tokens
    after the patches); encdec: its stub frames beside the tokens."""
    out = {k: torch.from_numpy(v).long()
           for k, v in data.batch_at(step).items()}
    if cfg.family == "vlm":
        out = concrete_batch(cfg, seq + cfg.n_patches, batch,
                             rng=np.random.default_rng(step))
    elif cfg.family == "encdec":
        out["frames"] = concrete_batch(
            cfg, seq, batch, rng=np.random.default_rng(step))["frames"]
    return {k: v.to(device) for k, v in out.items()}


def train(cfg: LMConfig, steps: int, batch: int, seq: int,
          opt_cfg: AdamWConfig, ckpt_dir: str, ckpt_every: int,
          fail_at: Sequence[int] = (), device="cuda"):
    """``steps`` train steps of ``cfg`` from random weights (seed 0)
    under a :class:`TrainSupervisor` with a :class:`CheckpointStore` in
    ``ckpt_dir`` (keep 2, every ``ckpt_every`` steps) and failures
    injected at ``fail_at``.  Returns ((params, opt_state), report,
    seconds)."""
    dev = resolve_device(device)
    data = SyntheticLMDataset(DataConfig(global_batch=batch, seq_len=seq,
                                         vocab=cfg.vocab))
    params, opt_state = steps_lib.init_train_state(
        cfg, dev, torch.Generator(dev).manual_seed(0))
    raw_step = steps_lib.make_train_step(
        cfg, opt_cfg, loss_chunk=loss_chunk(cfg, seq))

    def step_fn(state, step):
        params, opt_state = state
        b = step_batch(cfg, data, step, batch, seq, dev)
        params, opt_state, metrics = raw_step(params, opt_state, b)
        return (params, opt_state), {k: float(v) for k, v in metrics.items()}

    store = CheckpointStore(ckpt_dir, keep=2)
    sup = TrainSupervisor(store, step_fn, ckpt_every=ckpt_every,
                          injector=FailureInjector(fail_at_steps=fail_at))
    t0 = time.time()
    state, report = sup.run((params, opt_state), steps)
    return state, report, time.time() - t0


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject failures at these steps (FT demo)")
    ap.add_argument("--full", action="store_true",
                    help="use the full config (not for the CPU)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mod = configs.get(args.arch)
    cfg = mod.config() if args.full else mod.smoke_config()
    print(f"training {cfg.name} ({cfg.family}) for {args.steps} steps")
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=10,
                          total_steps=args.steps)
    _, report, dt = train(cfg, args.steps, args.batch, args.seq, opt_cfg,
                          args.ckpt_dir, args.ckpt_every, args.fail_at,
                          args.device)
    losses = [m["loss"] for _, m in report.history]
    print(f"done in {dt:.1f}s; restarts={report.restarts} "
          f"checkpoints={report.checkpoints}")
    print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f} "
          f"min={min(losses):.4f}")
    assert np.isfinite(losses).all(), "NaN loss"
    if len(losses) > 10:
        assert losses[-1] < losses[0], "loss did not decrease"
        print("loss decreased — training sanity OK")


if __name__ == "__main__":
    main()
