"""Pipelined decode-batch execution for the attention LM families (dense,
moe, vlm), in PyTorch.

:class:`PipelineDecodeEngine` runs the continuous decode batch through the
paper's host-threaded :class:`~repro_torch.core.pipeline.PipelineExecutor`,
one stage per plan segment, each stage on its own CUDA stream of the card.
Each stage owns its blocks' K/V caches, allocated once on the device and
laid out ``(n_blocks_stage, n_slots, max_context, n_kv_heads, head_dim)``
-- slot ``i`` is sequence ``i`` of the running batch, so admission and
eviction are just the scheduler re-using a slot index; no cache shuffling.

Two payload ops travel the stream:

* ``prefill`` -- one prompt (B=1, full-sequence causal attention through
  the flash-attention kernel) copies its post-RoPE K/V rows into rows
  ``[0, n)`` of slot ``i`` of every block cache, in place, and returns the
  first greedy token from the last position;
* ``step`` -- one decode step of *all* slots at once with a per-slot
  context vector: RoPE positions ``ctx-1`` (for vlm on all three M-RoPE
  streams, as the reference engine's); the new K/V rows written in
  place at ``ctx-1`` of the active slots only (``ctx=0`` slots stay
  untouched; the reference's one-hot write over the whole cache would move
  the whole cache every step); attention through the flash-decode kernel,
  which reads each slot's length from device memory and the layer cache as
  a ``(slots, Hkv, T, D)`` strided view.  The lengths, positions and write
  indices reach the card in one int32 copy per step per stage.  Inactive
  slots compute outputs that are never read.

Each stage synchronizes its stream before it returns, so the executor's
busy time is device time and the next stage reads a finished tensor.  That
also keeps the FIFO-per-stage ordering the scheduler's prefill-join relies
on: a prefill submitted before the next step has reached each stage's cache
before that step reads it.

The reference semantics are ``repro.models.lm.forward_decode`` fed one
token at a time (the tests pin exact greedy-token equality at B=1 in fp32).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core.pipeline import PipelineExecutor
from ..models import lm
from .costing import _itemsize
from .placement import DECODE_FAMILIES
from .scheduler import DecodeScheduler


class PipelineDecodeEngine:
    """The running decode batch over a staged attention LM.  ``params`` live on
    the device the engine runs on (their ``embed`` tensor's)."""

    def __init__(self, cfg: lm.LMConfig, params: Dict[str, Any], *,
                 n_slots: int, max_context: int,
                 stage_blocks: Optional[Sequence[int]] = None,
                 queue_size: int = 8):
        if cfg.family not in DECODE_FAMILIES:
            raise ValueError(
                f"PipelineDecodeEngine supports the scan-block attention "
                f"families {DECODE_FAMILIES}; {cfg.name} is "
                f"family={cfg.family!r}")
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if max_context < 2:
            raise ValueError(f"max_context must be >= 2, got {max_context}")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.n_slots = int(n_slots)
        self.max_context = int(max_context)
        if stage_blocks is None:
            stage_blocks = [cfg.n_layers]
        if sum(stage_blocks) != cfg.n_layers:
            raise ValueError(f"stage_blocks {list(stage_blocks)} must sum "
                             f"to n_layers={cfg.n_layers}")
        self.stage_blocks = [int(b) for b in stage_blocks]
        self._lock = threading.Lock()   # serialize prefill/step submitters
        fns = []
        lo = 0
        for si, nb in enumerate(self.stage_blocks):
            fns.append(self._build_stage(si, lo, lo + nb))
            lo += nb
        self.pipe = PipelineExecutor(fns, queue_size=queue_size,
                                     name=f"decode-{cfg.name}")

    # bytes one generated token adds across every layer's K+V cache --
    # the scheduler's per-slot KV-occupancy unit
    @property
    def kv_bytes_per_token(self) -> int:
        c = self.cfg
        return c.n_layers * 2 * c.n_kv_heads * c.hd * _itemsize(c.dtype)

    # -- stage construction ---------------------------------------------------
    def _build_stage(self, si: int, lo: int, hi: int):
        cfg, params, dev = self.cfg, self.params, self.device
        first = si == 0
        last = si == len(self.stage_blocks) - 1
        blocks = params["blocks"][lo:hi]
        n = self.n_slots
        shape = (hi - lo, n, self.max_context, cfg.n_kv_heads, cfg.hd)
        kc = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        vc = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

        def tokens_in(x) -> torch.Tensor:
            return torch.from_numpy(np.asarray(x, np.int64)).to(dev)

        def prefill(slot: int, x):
            h = lm.embed_tokens(cfg, params, tokens_in(x)) if first else x
            pos = lm.positions_for(cfg, h)
            for i, bp in enumerate(blocks):
                h = lm.block(cfg, bp, h, pos,
                             cache_rows=(kc[i, slot:slot + 1],
                                         vc[i, slot:slot + 1]))
            if last:
                logits = lm.unembed(cfg, params, h[:, -1:])
                return ("token", int(logits[0, -1].argmax()))
            return ("prefill", slot, h)

        def step(x, ctx: np.ndarray):
            # one int32 copy: lengths (n) | RoPE positions (n) | active
            # slots (a) | their write positions (a)
            act = np.flatnonzero(ctx > 0)
            idx = torch.from_numpy(np.concatenate(
                [ctx, np.maximum(ctx - 1, 0), act, ctx[act] - 1]
            ).astype(np.int32)).to(dev)
            lens, pos = idx[:n], idx[n:2 * n, None]
            if cfg.family == "vlm":             # every M-RoPE stream
                pos = pos[None].expand(3, n, 1)
            write = (idx[2 * n:2 * n + act.size], idx[2 * n + act.size:])
            h = lm.embed_tokens(cfg, params, tokens_in(x)) if first else x
            for i, bp in enumerate(blocks):
                h = lm.block_decode(cfg, bp, h, kc[i], vc[i], lens, pos,
                                    write)
            if last:
                logits = lm.unembed(cfg, params, h)
                return ("tokens", logits[:, -1].argmax(-1).cpu().numpy())
            return ("step", h, ctx)

        def stage(payload):
            op = payload[0]
            if op not in ("prefill", "step"):
                raise ValueError(f"unknown decode payload op {op!r}")
            with torch.cuda.stream(stream):
                out = prefill(*payload[1:]) if op == "prefill" \
                    else step(*payload[1:])
                if stream is not None:
                    stream.synchronize()
            return out

        return stage

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "PipelineDecodeEngine":
        self.pipe.start()
        return self

    def stop(self) -> None:
        self.pipe.stop()

    def __enter__(self) -> "PipelineDecodeEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- scheduler protocol ---------------------------------------------------
    def prefill(self, slot: int, prompt: np.ndarray) -> int:
        """Write the prompt's KV into ``slot``; return the first greedy
        token."""
        prompt = np.asarray(prompt, np.int32).reshape(1, -1)
        if not (0 <= slot < self.n_slots):
            raise ValueError(f"slot {slot} out of range 0..{self.n_slots-1}")
        if prompt.shape[1] >= self.max_context:
            raise ValueError(f"prompt of {prompt.shape[1]} tokens leaves no "
                             f"room in max_context={self.max_context}")
        with self._lock:
            fut = self.pipe.submit(("prefill", int(slot), prompt))
        op, tok = fut.result()
        return tok

    def step(self, slots: Sequence[int], ctx_lens: Sequence[int],
             last_tokens: Sequence[int]) -> List[int]:
        """One decode step of the listed slots (the rest idle in-batch);
        returns their next greedy tokens in the same order."""
        tokens = np.zeros((self.n_slots, 1), np.int32)
        ctx = np.zeros((self.n_slots,), np.int32)
        for s, c, tk in zip(slots, ctx_lens, last_tokens):
            if not (2 <= c <= self.max_context):
                raise ValueError(f"slot {s}: context {c} outside "
                                 f"2..{self.max_context}")
            tokens[s, 0] = tk
            ctx[s] = c
        with self._lock:
            fut = self.pipe.submit(("step", tokens, ctx))
        op, out = fut.result()
        return [int(out[s]) for s in slots]


class DecodeServer:
    """Engine + scheduler lifecycle bundle -- what ``Deployment.serve``
    returns for ``workload="decode"``.  ``submit`` streams tokens via the
    returned :class:`~repro_torch.decode.scheduler.DecodeRequest`."""

    def __init__(self, engine: PipelineDecodeEngine,
                 scheduler: DecodeScheduler):
        self.engine = engine
        self.scheduler = scheduler

    def start(self) -> "DecodeServer":
        self.engine.start()
        self.scheduler.start()
        return self

    def stop(self, drain: bool = True) -> None:
        self.scheduler.stop(drain=drain)
        self.engine.stop()

    def __enter__(self) -> "DecodeServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def submit(self, prompt, max_new_tokens: Optional[int] = None):
        return self.scheduler.submit(prompt, max_new_tokens)

    def snapshot(self) -> Dict[str, Any]:
        return self.scheduler.snapshot()


def build_decode_server(spec, plan=None, params=None, seed: int = 0, *,
                        cfg: Optional[lm.LMConfig] = None,
                        **scheduler_kw) -> DecodeServer:
    """Wire a :class:`DecodeServer` from a deployment spec (+ optionally
    its plan, whose stage cuts become pipeline stages).

    ``cfg`` is the config the plan priced (the spec's smoke config when
    None, as in the reference); ``params`` its weights on the device to
    serve on.  ``params=None`` draws smoke weights from ``seed`` on the
    card, and only for the spec's own smoke config."""
    from .placement import decode_config_for, operating_point
    smoke = cfg is None
    if smoke:
        cfg = decode_config_for(spec.model)
    if cfg.family not in DECODE_FAMILIES:
        raise ValueError(
            f"decode serving runs the scan-block attention families "
            f"{DECODE_FAMILIES}; {cfg.name} is family={cfg.family!r} "
            f"(recurrent/enc-dec families plan with 'decode_placement' "
            f"but have no continuous-batching engine yet)")
    point = operating_point(spec)
    if params is None:
        if not smoke:
            raise ValueError(f"serving {cfg.name} needs its weights: pass "
                             f"params (random weights are drawn only for "
                             f"the spec's smoke config)")
        dev = resolve_device("cuda")
        params = lm.init_params(cfg, dev,
                                torch.Generator(dev).manual_seed(seed))
    stage_blocks = None
    if plan is not None:
        from ..launch.serve import stage_block_counts
        stage_blocks = stage_block_counts(plan, cfg.n_layers)
    engine = PipelineDecodeEngine(cfg, params,
                                  n_slots=point.concurrency,
                                  max_context=point.max_context,
                                  stage_blocks=stage_blocks)
    sched = DecodeScheduler(engine, max_context=point.max_context,
                            **scheduler_kw)
    return DecodeServer(engine, sched)
