"""Continuous batching for autoregressive decode.

Sequential serving decodes one request to completion before admitting the
next — every step runs at batch 1 and the pipeline idles between
requests.  :class:`DecodeScheduler` keeps one *running decode batch* over
a fixed set of slots and:

* **admits at token boundaries** — between engine steps, pending prompts
  are prefilled into free slots and join the very next step (no drain, no
  batch barrier);
* **evicts finished sequences** (token budget or EOS) immediately, so a
  freed slot is refilled at the next boundary;
* **tracks per-slot KV occupancy** (context length x the engine's
  per-token KV bytes) — :meth:`snapshot` exposes it;
* **sheds at the KV cap**: slots *are* the planned KV budget
  (``decode_concurrency`` at ``max_context``); when every slot is busy
  requests queue, and when the queue is full they complete immediately
  with :class:`~repro_torch.serving.server.Overloaded` carrying the
  server's jittered-exponential ``retry_after_s`` hint (seeded, reset on the
  first successful enqueue);
* **drains on stop()**: in-flight sequences run to completion,
  never-admitted ones complete with
  :class:`~repro_torch.core.pipeline.PipelineStopped`.

Token order per request is by construction: one scheduler thread owns the
engine, appends tokens sequentially, and stamps each with its index —
the audit the decode bench asserts (zero lost, zero misordered).

The engine is duck-typed (see :class:`repro_torch.decode.engine
.PipelineDecodeEngine` for the real one; tests use scripted fakes):
``n_slots``; ``prefill(slot, prompt) -> first_token``;
``step(slots, ctx_lens, last_tokens) -> next_tokens``; optionally
``release(slot)``, ``kv_bytes_per_token``, ``start()``/``stop()``.
"""
from __future__ import annotations

import dataclasses
import itertools
import queue
import random
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..core.pipeline import PipelineStopped
from ..serving.server import Overloaded

_RID = itertools.count()


@dataclasses.dataclass
class DecodeRequest:
    """One streaming decode request.

    ``stream`` yields ``(index, token)`` pairs as they are generated
    (index is the token's position in the response, 0-based, strictly
    increasing); ``tokens`` accumulates them; ``event`` fires at
    completion with ``error`` set on shed/stop."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    stream: "queue.Queue" = dataclasses.field(default_factory=queue.Queue)
    error: Optional[BaseException] = None
    event: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    t_submit: float = dataclasses.field(default_factory=time.perf_counter)
    t_first: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.event.is_set()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until completion; raises the completion error if any."""
        if not self.event.wait(timeout):
            raise TimeoutError(f"decode request {self.rid} timed out")
        if self.error is not None:
            raise self.error
        return list(self.tokens)


@dataclasses.dataclass
class _Slot:
    req: DecodeRequest
    context_len: int          # valid cache positions (prompt + generated)
    last_token: int


class DecodeScheduler:
    """Continuous-batching admission/eviction loop over a decode engine."""

    def __init__(self, engine, *, max_context: int,
                 default_max_new_tokens: int = 32,
                 eos_token: Optional[int] = None,
                 queue_size: int = 64,
                 backoff_base_s: float = 0.05,
                 backoff_max_s: float = 2.0,
                 backoff_seed: int = 0):
        if max_context < 2:
            raise ValueError(f"max_context must be >= 2, got {max_context}")
        if queue_size < 1:
            raise ValueError(f"queue_size must be >= 1, got {queue_size}")
        if backoff_base_s <= 0 or backoff_max_s < backoff_base_s:
            raise ValueError("need 0 < backoff_base_s <= backoff_max_s")
        self.engine = engine
        self.n_slots = int(engine.n_slots)
        if self.n_slots < 1:
            raise ValueError(f"engine has no slots ({self.n_slots})")
        self.max_context = max_context
        self.default_max_new_tokens = default_max_new_tokens
        self.eos_token = eos_token
        self.queue_size = queue_size
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self._backoff_rng = random.Random(backoff_seed)
        self._consec_sheds = 0

        self._cond = threading.Condition()
        self._pending: deque = deque()
        self._slots: List[Optional[_Slot]] = [None] * self.n_slots
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._drain = True
        self._seq_s_ewma: Optional[float] = None   # per-sequence service
        # monotonic counters + gap samples; snapshot() takes deltas
        self._stats = {"admitted": 0, "shed": 0, "completed": 0,
                       "tokens": 0, "steps": 0}
        self._last_stats = dict(self._stats)
        self._gaps: List[float] = []
        self._last_t = time.perf_counter()

    # -- submission ----------------------------------------------------------
    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None) -> DecodeRequest:
        """Enqueue a prompt.  Returns immediately; the request streams
        tokens as the running batch reaches it.  At the KV cap (all slots
        busy + full queue) the request completes *now* with
        :class:`Overloaded` + a retry hint instead of waiting unbounded."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        budget = (max_new_tokens if max_new_tokens is not None
                  else self.default_max_new_tokens)
        req = DecodeRequest(rid=next(_RID), prompt=prompt,
                            max_new_tokens=max(1, int(budget)))
        if prompt.size < 1 or prompt.size >= self.max_context:
            self._finish(req, ValueError(
                f"prompt of {prompt.size} tokens does not fit "
                f"max_context={self.max_context} (need >= 1 and room for "
                f"at least one generated token)"))
            return req
        with self._cond:
            if self._stopping:
                self._finish(req, PipelineStopped(
                    RuntimeError("decode scheduler is stopping")))
                return req
            if len(self._pending) >= self.queue_size:
                retry = self._retry_after_s()
                self._consec_sheds += 1
                self._stats["shed"] += 1
                est = (len(self._pending)
                       * (self._seq_s_ewma or retry)) / self.n_slots
                self._finish(req, Overloaded(req.rid, retry, est))
                return req
            self._consec_sheds = 0     # accepted: reset the backoff ladder
            self._pending.append(req)
            self._cond.notify()
        return req

    def _retry_after_s(self) -> float:
        """The server's shed semantics: jittered exponential backoff over
        consecutive sheds (seeded => deterministic in tests)."""
        base = min(self.backoff_max_s,
                   self.backoff_base_s * (2.0 ** self._consec_sheds))
        return base * (1.0 + 0.25 * self._backoff_rng.random())

    def _finish(self, req: DecodeRequest,
                error: Optional[BaseException] = None) -> None:
        req.error = error
        req.t_done = time.perf_counter()
        req.event.set()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "DecodeScheduler":
        with self._cond:
            if self._thread is not None:
                return self            # idempotent: already running
            self._stopping = False
            self._thread = threading.Thread(target=self._loop,
                                            name="decode-sched",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the loop.  ``drain=True`` (default) completes every
        *admitted* (in-flight) sequence first; pending never-admitted
        requests complete with :class:`PipelineStopped` either way."""
        with self._cond:
            self._stopping = True
            self._drain = drain
            self._cond.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout=300)
            self._thread = None
        # no loop ever ran: fail whatever is still queued/slotted
        with self._cond:
            leftovers = list(self._pending)
            self._pending.clear()
            slots = [s for s in self._slots if s is not None]
            self._slots = [None] * self.n_slots
        for req in leftovers:
            self._finish(req, PipelineStopped(
                RuntimeError("decode scheduler stopped before admission")))
        for sl in slots:
            self._finish(sl.req, PipelineStopped(
                RuntimeError("decode scheduler stopped mid-sequence")))

    def __enter__(self) -> "DecodeScheduler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the loop ------------------------------------------------------------
    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def _emit(self, slot: _Slot, token: int) -> bool:
        """Append one token to the slot's request (index = position).
        Returns True when the sequence just finished."""
        req = slot.req
        now = time.perf_counter()
        if req.t_first is None:
            req.t_first = now
        else:
            self._gaps.append(now - req.t_done_gap)   # type: ignore
        req.t_done_gap = now                           # type: ignore
        req.tokens.append(int(token))
        req.stream.put((len(req.tokens) - 1, int(token)))
        self._stats["tokens"] += 1
        slot.last_token = int(token)
        if len(req.tokens) >= req.max_new_tokens:
            return True
        if self.eos_token is not None and int(token) == self.eos_token:
            return True
        return slot.context_len + 1 >= self.max_context

    def _evict(self, idx: int) -> None:
        sl = self._slots[idx]
        self._slots[idx] = None
        release = getattr(self.engine, "release", None)
        if release is not None:
            release(idx)
        self._stats["completed"] += 1
        dt = time.perf_counter() - sl.req.t_submit
        ew = self._seq_s_ewma
        self._seq_s_ewma = dt if ew is None else 0.7 * ew + 0.3 * dt
        self._finish(sl.req)

    def _loop(self) -> None:
        while True:
            with self._cond:
                while (not self._stopping and not self._pending
                       and all(s is None for s in self._slots)):
                    self._cond.wait(timeout=0.5)
                if self._stopping:
                    drain = self._drain
                    # pending requests are never admitted past stop()
                    rejected = list(self._pending)
                    self._pending.clear()
                    active = [s for s in self._slots if s is not None]
                    if not drain:
                        self._slots = [None] * self.n_slots
                else:
                    drain, rejected, active = True, [], None
                admits = []
                if not self._stopping:
                    for idx in self._free_slots():
                        if not self._pending:
                            break
                        admits.append((idx, self._pending.popleft()))
            for req in rejected:
                self._finish(req, PipelineStopped(
                    RuntimeError("decode scheduler stopped before this "
                                 "request was admitted")))
            if self._stopping:
                if not drain:
                    for sl in active:
                        self._finish(sl.req, PipelineStopped(
                            RuntimeError("decode scheduler stopped "
                                         "mid-sequence")))
                    return
                if not any(s is not None for s in self._slots):
                    return                     # drained: all in-flight done

            # prefill-join at the token boundary: each admitted prompt is
            # prefilled and contributes its first token before the next
            # batched step
            for idx, req in admits:
                self._stats["admitted"] += 1
                first = self.engine.prefill(idx, req.prompt)
                sl = _Slot(req=req, context_len=req.prompt.size + 1,
                           last_token=int(first))
                self._slots[idx] = sl
                if self._emit(sl, first):
                    self._evict(idx)

            # one decode step of the whole running batch
            live = [(i, s) for i, s in enumerate(self._slots)
                    if s is not None]
            if not live:
                continue
            idxs = [i for i, _ in live]
            ctxs = [s.context_len for _, s in live]
            toks = [s.last_token for _, s in live]
            nxt = self.engine.step(idxs, ctxs, toks)
            self._stats["steps"] += 1
            for (i, sl), tok in zip(live, nxt):
                sl.context_len += 1
                if self._emit(sl, tok):
                    self._evict(i)

    # -- telemetry -----------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Delta counters since the last snapshot + live slot/KV state."""
        now = time.perf_counter()
        with self._cond:
            cur = dict(self._stats)
            delta = {k: cur[k] - self._last_stats[k] for k in cur}
            self._last_stats = cur
            gaps = sorted(self._gaps)
            self._gaps = []
            kv_per_tok = int(getattr(self.engine, "kv_bytes_per_token", 0))
            slots = [{"slot": i, "rid": s.req.rid,
                      "context_len": s.context_len,
                      "kv_bytes": s.context_len * kv_per_tok}
                     for i, s in enumerate(self._slots) if s is not None]
            queue_depth = len(self._pending)
        window = max(now - self._last_t, 1e-9)
        self._last_t = now

        def pct(p: float) -> float:
            if not gaps:
                return 0.0
            return gaps[min(len(gaps) - 1, int(p * len(gaps)))]

        delta.update(
            tokens_per_s=delta["tokens"] / window,
            window_s=window,
            inter_token_p50_s=pct(0.50),
            inter_token_p95_s=pct(0.95),
            slots=slots,
            slots_busy=len(slots),
            n_slots=self.n_slots,
            kv_bytes_total=sum(s["kv_bytes"] for s in slots),
            queue_depth=queue_depth)
        return delta
