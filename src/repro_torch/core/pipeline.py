"""Host-threaded *streaming* pipeline executor — faithful to the paper's
implementation, extended with replicated stages and dynamic micro-batching.

Paper §5.1 / Fig. 5: "we deploy a host thread per Edge TPU that is in charge
of handling it, and a queue (implementing thread-safe mechanisms) on the host
to communicate intermediate results among devices."

Here each *stage* owns worker thread(s) and an input queue; stage ``i`` pops
an item, applies its stage function, and pushes the result to stage ``i+1``'s
queue.  Stage functions are arbitrary callables: the CNN benchmarks bind them
to real JAX forwards of the stage's layers; tests bind simulated latencies to
validate the analytical pipeline model.

The executor is *persistent* and *streaming*:

* Worker threads and their bounded queues are created once (on first use or
  an explicit :meth:`PipelineExecutor.start`) and reused, so steady-state
  serving creates **zero** threads per request.
* :meth:`PipelineExecutor.submit` admits one item into the stream and
  returns a :class:`concurrent.futures.Future`; envelopes flow through the
  stage queues continuously with **no inter-batch barrier** — a collector
  thread at the tail completes each item's future as it exits the last
  stage.  Backpressure comes from the bounded inter-stage queues:
  ``submit`` blocks once ``queue_size`` items are waiting at the head.
* :meth:`PipelineExecutor.run_batch` rides the same stream: it admits the
  whole batch through the same admission path and gathers completions in
  submission order (via a shared batch sink — one slot per item — rather
  than a Future each, keeping the per-item overhead tens of microseconds),
  so outputs (and the first-error-in-submission-order contract) are
  identical to the historical batch-synchronous executor — but two callers
  can now interleave batches, and a serving loop can keep every stage busy
  across what used to be drain/refill bubbles at batch boundaries.
* Stage failures are wrapped and forwarded per item (:class:`_Failed`), so
  one bad input neither kills worker threads nor stalls the stream; the
  item's future receives the original exception.
* :meth:`PipelineExecutor.stop` drains the stream and completes any future
  still in flight with :class:`PipelineStopped` rather than leaving callers
  hanging; the executor may be restarted afterwards.

Busy-time accounting is **monotonic**: per-(stage, replica) counters only
ever grow, and :meth:`busy_snapshot` returns the per-stage totals so callers
measure intervals as snapshot deltas (``run_batch(collect_stage_times=True)``
does exactly that — note the delta spans everything the executor ran in the
interval, which equals the batch only when no other traffic interleaves).

**Replicated stages** (``replicas=[...]``, from a
:class:`~repro_torch.core.placement.PlacementPlan`): a stage with ``k > 1``
replicas — a bottleneck a single dominant layer pins, which no cut
placement can fix — runs ``k`` workers sharing the stage function.  A
dispatcher thread round-robins envelopes from the stage's input queue onto
``k`` per-worker queues; workers push results into a shared queue; a merge
thread restores stream order (items carry monotonic sequence numbers
internally) before forwarding downstream, so the pipeline's in-order
contract is bit-for-bit identical to the unreplicated pipeline — only the
pacing changes.  The merge sequence is monotonic for the executor's whole
lifetime: there is no per-batch reset, which is what lets batches overlap
in flight.

**Dynamic micro-batching** (``microbatch=[...]`` or an int): a stage with
bucket size ``k > 1`` aggregates up to ``k`` *consecutive* queued envelopes
whose payloads share an array signature (shape + dtype, the
:class:`ShapeKeyedStageCache` bucketing key) into one stacked call —
``fn(concat(payloads))`` split back into per-item envelopes — so jitted
accelerator stages amortize dispatch and weight-load over the traffic that
is actually concurrent, not just over what one request batch happened to
contain.  Only a same-signature *prefix* of the queue is taken, so FIFO
order (and therefore the stream's in-order contract) is preserved exactly;
``microbatch_wait_s`` optionally holds the first item briefly to let a
fuller bucket form.  Stages whose output does not split back along the
leading axis are detected on the first stacked probe and run per-item
from then on.

**Failure domains** (fleet-scale serving): the executor
distinguishes *item* failures from *replica* failures.  An ordinary stage
exception travels the stream as :class:`_Failed` and resolves that item's
future (unchanged).  A :class:`ReplicaFailure` — raised by a stage function
when its device dies, or injected via :meth:`PipelineExecutor.kill_replica`
by a health monitor / chaos harness — retires the *worker*: every envelope
the replica had accepted but not emitted (tracked in a per-stage in-flight
registry) is re-dispatched to a surviving replica and slots back into the
order-restoring merge by stream sequence, so no request is lost or
misordered.  When a stage loses its **last** replica the stage fails fast —
envelopes cross it as ``_Failed(StageLost)`` so the stream keeps flowing and
futures resolve promptly — and the ``on_stage_lost`` callback fires exactly
once (the hook degraded-mode replanning hangs off; see
``runtime.ft.HealthMonitor``).  Because re-dispatch is at-least-once, the
merge deduplicates by sequence: the first result for a sequence wins,
duplicates are dropped.

**Hedged dispatch** (``hedge_after=t``): on a replicated stage, an envelope
still in flight ``t`` seconds after dispatch is speculatively re-issued to a
*different* live replica; first result wins via the merge's
dedup-by-sequence, so outputs are bit-identical to unhedged execution —
only tail latency changes.  Off by default; enabled per deployment through
``DeploymentSpec.hedge_after``.

Liveness/health is observable via :meth:`PipelineExecutor.health_snapshot`:
per-replica alive flags, heartbeat ages, consecutive item-failure counts,
and per-stage hedge/re-dispatch counters.

This executor is the *paper-faithful* path (host-mediated transfers).  The
pod-scale SPMD path (shard_map + ppermute over ICI) lives in
launch/pipeline_spmd.py and consumes the same PlacementPlan.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

_SHUTDOWN = object()      # terminates workers; forwarded by every stage
_DEAD_TOKEN = object()    # a replica's one-time termination token on death
_DISPATCHER_DONE = object()   # dispatcher -> merge: drain marker delivered
_RETIRE = object()        # killer -> worker: your queue was reclaimed, exit


class PipelineStopped(RuntimeError):
    """Completion error for futures still in flight when the executor (or a
    server built on it) shuts down: callers get this instead of hanging."""


class ReplicaFailure(RuntimeError):
    """The *replica* (device/worker) died, not the item.

    Raised by a stage function when its backing device is gone (JAX device
    loss, a withdrawn Edge TPU) or injected by the chaos harness.  The
    worker retires and its in-flight envelopes are re-dispatched to a
    surviving replica; the item that triggered it is *not* failed."""


class StageLost(RuntimeError):
    """Completion error for envelopes crossing a stage with no live
    replicas left.  Carries ``stage`` so retry policies and the degraded-
    mode replanner know which failure domain collapsed."""

    def __init__(self, stage: int, name: str = "pipeline"):
        super().__init__(f"{name}: stage {stage} has no live replicas")
        self.stage = stage


class _Failed:
    """A stage exception travelling the pipeline in the failed item's slot.

    Downstream stages forward it untouched, so one bad input neither kills
    the worker threads nor stalls the rest of the stream."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


class _BatchSink:
    """Lightweight completion target for ``run_batch``: one preallocated
    slot per item and a single Event, instead of a condition-variable
    Future per item — the gather path costs one lock op per item, which
    keeps the zero-latency steady-state microbenchmark within a few tens
    of microseconds per item."""

    __slots__ = ("slots", "_remaining", "_lock", "done")

    def __init__(self, n: int):
        self.slots: List[Any] = [None] * n
        self._remaining = n
        self._lock = threading.Lock()
        self.done = threading.Event()

    def deliver(self, idx: int, payload: Any) -> None:
        self.slots[idx] = (payload,)      # tuple-wrap: None is a valid output
        with self._lock:
            self._remaining -= 1
            if self._remaining == 0:
                self.done.set()


class _InFlight:
    """Registry record for an envelope a replicated stage has accepted but
    not yet emitted: the payload (for re-dispatch), the replica currently
    working on it, the dispatch time (for hedging), and whether a hedged
    duplicate was already issued."""

    __slots__ = ("payload", "slot", "t_dispatch", "hedged")

    def __init__(self, payload: Any, slot: int = -1):
        self.payload = payload
        self.slot = slot
        self.t_dispatch = time.monotonic()
        self.hedged = False


class _StageState:
    """Shared failure-domain state of one replicated stage: worker queues,
    the merge input queue, per-replica liveness, and the in-flight
    registry (seq -> :class:`_InFlight`).  ``token_emitted`` guarantees
    each of the ``k`` workers contributes exactly one termination token
    (_DEAD_TOKEN on death, _SHUTDOWN on drain) to the merge, whichever
    path retires it first."""

    __slots__ = ("idx", "k", "wqs", "mq", "lock", "alive", "token_emitted",
                 "inflight", "hedges", "redispatches", "rr")

    def __init__(self, idx: int, k: int, wqs: List[queue.Queue],
                 mq: queue.Queue):
        self.idx = idx
        self.k = k
        self.wqs = wqs
        self.mq = mq
        self.lock = threading.Lock()
        self.alive = [True] * k
        self.token_emitted = [False] * k
        self.inflight: Dict[int, _InFlight] = {}
        self.hedges = 0
        self.redispatches = 0
        self.rr = 0


class PipelineExecutor:
    """Run inputs through a chain of stage functions with persistent
    worker threads and reusable bounded queues between stages.

    ``replicas[i] > 1`` replicates stage ``i`` across that many workers
    (shared input queue via a round-robin dispatcher, order-restoring
    fan-in).  ``microbatch[i] > 1`` lets stage ``i`` stack consecutive
    same-shape payloads into one call (see module docstring).  Items travel
    internally as ``(seq, payload)`` envelopes; user code never sees them.
    """

    def __init__(self, stage_fns: Sequence[Callable[[Any], Any]],
                 queue_size: int = 64, name: str = "pipeline",
                 replicas: Optional[Sequence[int]] = None,
                 microbatch: Optional[Union[int, Sequence[int]]] = None,
                 microbatch_wait_s: float = 0.0,
                 hedge_after: Optional[float] = None):
        if not stage_fns:
            raise ValueError("need at least one stage")
        if hedge_after is not None and hedge_after <= 0:
            raise ValueError(f"hedge_after must be > 0, got {hedge_after}")
        self.stage_fns = list(stage_fns)
        self.queue_size = queue_size
        self.name = name
        n = len(self.stage_fns)
        if replicas is None:
            replicas = [1] * n
        self.replicas = [int(r) for r in replicas]
        if len(self.replicas) != n:
            raise ValueError(f"need {n} replica counts, "
                             f"got {len(self.replicas)}")
        if any(r < 1 for r in self.replicas):
            raise ValueError(f"replica counts must be >= 1: {self.replicas}")
        if microbatch is None:
            microbatch = [1] * n
        elif isinstance(microbatch, int):
            microbatch = [microbatch] * n
        self.microbatch = [int(k) for k in microbatch]
        if len(self.microbatch) != n:
            raise ValueError(f"need {n} microbatch sizes, "
                             f"got {len(self.microbatch)}")
        if any(k < 1 for k in self.microbatch):
            raise ValueError(f"microbatch sizes must be >= 1: "
                             f"{self.microbatch}")
        self.microbatch_wait_s = float(microbatch_wait_s)
        self.hedge_after = hedge_after
        # fired exactly once when stage i loses its last replica; called
        # from an executor thread, so implementors must not block (the
        # HealthMonitor hook just enqueues an event)
        self.on_stage_lost: Optional[Callable[[int], None]] = None
        self._lock = threading.RLock()      # lifecycle
        self._submit_lock = threading.Lock()  # seq assignment + head put
        self._health_lock = threading.Lock()  # stage-lost once-only guard
        self._queues: List[queue.Queue] = []
        self._threads: List[threading.Thread] = []
        # one busy slot per (stage, replica): each written by one thread
        # only, never reset — read intervals via busy_snapshot() deltas
        self._busy = [[0.0] * r for r in self.replicas]
        # items successfully applied per (stage, replica), same single-
        # writer discipline: busy/items deltas = observed per-item stage
        # time, the live-telemetry signal the self-healing loop refits from
        self._items = [[0] * r for r in self.replicas]
        # micro-batching amortization counters (calls / items): one slot
        # per (stage, replica) like _busy, so concurrent replica workers
        # never lose updates; monotonic
        self._mb_calls = [[0] * r for r in self.replicas]
        self._mb_items = [[0] * r for r in self.replicas]
        # stages proven unstackable (output does not split along axis 0):
        # skip aggregation instead of re-running every bucket twice
        self._mb_unstackable = [False] * n
        # failure-domain state: per-replica liveness/heartbeats/consecutive
        # item failures (single-writer slots like _busy), per-replicated-
        # stage shared state, and the once-only stage-lost latches
        self._dead = [[False] * r for r in self.replicas]
        self._beats = [[time.monotonic()] * r for r in self.replicas]
        self._consec_fails = [[0] * r for r in self.replicas]
        self._stage_states: List[Optional[_StageState]] = [None] * n
        self._stage_lost_fired = [False] * n
        self._hedge_stop = threading.Event()
        # seq -> Future (submit) or (_BatchSink, idx) (run_batch)
        self._pending: Dict[int, Any] = {}
        self._seq = itertools.count()
        self._started = False
        self._draining = False

    @classmethod
    def for_plan(cls, plan, stage_fns: Sequence[Callable[[Any], Any]],
                 queue_size: int = 64,
                 microbatch: Optional[Union[int, Sequence[int]]] = None,
                 microbatch_wait_s: float = 0.0,
                 hedge_after: Optional[float] = None,
                 name_prefix: str = "pipeline") -> "PipelineExecutor":
        """The one place a plan's execution shape (replica fan-out) meets
        a serving policy: both ``PipelinedModelServer`` and the
        ``repro_torch.api.Deployment`` handle build their executors here, so a
        new executor knob lands in every consumer at once."""
        return cls(stage_fns, queue_size=queue_size,
                   name=f"{name_prefix}-{plan.graph_name}",
                   replicas=getattr(plan, "replica_counts", None),
                   microbatch=microbatch,
                   microbatch_wait_s=microbatch_wait_s,
                   hedge_after=hedge_after)

    @property
    def n_stages(self) -> int:
        return len(self.stage_fns)

    @property
    def n_workers(self) -> int:
        return sum(self.replicas)

    @property
    def n_threads(self) -> int:
        """Threads the running executor owns: stage workers, dispatcher +
        merge per replicated stage, the tail collector, and the hedge
        monitor when hedging is enabled on a replicated pipeline."""
        hedger = 1 if (self.hedge_after is not None
                       and any(k > 1 for k in self.replicas)) else 0
        return (sum(1 if k == 1 else k + 2 for k in self.replicas)
                + 1 + hedger)

    @property
    def started(self) -> bool:
        return self._started

    @property
    def in_flight(self) -> int:
        """Submitted items whose futures have not completed yet."""
        return len(self._pending)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "PipelineExecutor":
        """Create the queues and spawn the persistent worker threads."""
        with self._lock:
            if self._started:
                return self
            n = self.n_stages
            self._queues = [queue.Queue(self.queue_size) for _ in range(n + 1)]
            self._threads = []
            self._pending = {}
            self._seq = itertools.count()
            self._draining = False
            # fresh failure-domain state: a restart resurrects every replica
            self._dead = [[False] * r for r in self.replicas]
            self._beats = [[time.monotonic()] * r for r in self.replicas]
            self._consec_fails = [[0] * r for r in self.replicas]
            self._stage_states = [None] * n
            self._stage_lost_fired = [False] * n
            self._hedge_stop = threading.Event()
            for i in range(n):
                k = self.replicas[i]
                if k == 1:
                    self._threads.append(threading.Thread(
                        target=self._stage_loop,
                        args=(i, self._queues[i], self._queues[i + 1], 0),
                        daemon=True, name=f"{self.name}-stage{i}"))
                    continue
                # replicated stage: dispatcher -> k workers -> merge
                wqs = [queue.Queue(max(2, self.queue_size // k))
                       for _ in range(k)]
                mq: queue.Queue = queue.Queue(self.queue_size)
                st = _StageState(i, k, wqs, mq)
                self._stage_states[i] = st
                self._threads.append(threading.Thread(
                    target=self._dispatcher, args=(i, self._queues[i], st),
                    daemon=True, name=f"{self.name}-stage{i}-dispatch"))
                for j in range(k):
                    self._threads.append(threading.Thread(
                        target=self._stage_loop,
                        args=(i, wqs[j], mq, j, st),
                        daemon=True, name=f"{self.name}-stage{i}-r{j}"))
                self._threads.append(threading.Thread(
                    target=self._merge, args=(st, self._queues[i + 1]),
                    daemon=True, name=f"{self.name}-stage{i}-merge"))
            self._threads.append(threading.Thread(
                target=self._collector, args=(self._queues[n], self._pending),
                daemon=True, name=f"{self.name}-collect"))
            if (self.hedge_after is not None
                    and any(k > 1 for k in self.replicas)):
                self._threads.append(threading.Thread(
                    target=self._hedger, daemon=True,
                    name=f"{self.name}-hedge"))
            for t in self._threads:
                t.start()
            self._started = True
            return self

    def submit(self, payload: Any) -> "Future":
        """Admit one item into the stream; returns a Future completed (with
        the tail stage's output, or the stage exception) as the item exits
        the pipeline.  Blocks when the head queue is full — the stream's
        backpressure.  Starts the executor if needed."""
        if not self._started:
            self.start()
        fut: Future = Future()
        with self._submit_lock:
            if self._draining or not self._started:
                raise RuntimeError(f"{self.name}: executor is stopping")
            seq = next(self._seq)
            self._pending[seq] = fut
            self._queues[0].put((seq, payload))
        return fut

    def stop(self, timeout: float = 30.0) -> None:
        """Drain and join the worker threads; the executor may be restarted.

        In-flight items ahead of the shutdown marker complete normally
        (their futures resolve during the drain).  Bounded: if a stage
        hangs and the marker never cascades to the tail within ``timeout``,
        the (daemon) workers are abandoned, and any future still pending is
        completed with :class:`PipelineStopped` rather than left hanging."""
        with self._lock:
            if not self._started:
                return
            deadline = time.monotonic() + timeout
            # refuse new submissions, then queue the marker behind every
            # already-accepted envelope
            if self._submit_lock.acquire(
                    timeout=max(0.01, deadline - time.monotonic())):
                try:
                    self._draining = True
                    self._queues[0].put(_SHUTDOWN)
                except BaseException:
                    self._submit_lock.release()
                    raise
                self._submit_lock.release()
            else:   # a submitter is wedged on a full queue: best effort
                self._draining = True
                try:
                    self._queues[0].put_nowait(_SHUTDOWN)
                except queue.Full:
                    pass
            self._hedge_stop.set()
            for t in self._threads:
                t.join(timeout=max(0.0, deadline - time.monotonic()))
            pending, self._pending = self._pending, {}
            for seq in sorted(pending):
                # atomic pop: an abandoned collector may race us here, and
                # exactly one side must complete each entry
                entry = pending.pop(seq, None)
                if entry is None:
                    continue
                err = PipelineStopped(
                    f"{self.name}: stopped with item {seq} in flight")
                if isinstance(entry, Future):
                    if not entry.done():
                        try:
                            entry.set_exception(err)
                        except Exception:
                            pass    # completed concurrently by a straggler
                else:
                    sink, idx = entry
                    sink.deliver(idx, _Failed(err))
            self._threads = []
            self._queues = []
            self._started = False
            self._draining = False

    def __enter__(self) -> "PipelineExecutor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- workers -------------------------------------------------------------
    def _apply(self, i: int, slot: int, envelope: Tuple[int, Any]):
        """Run stage ``i`` on one envelope; failures become _Failed.

        :class:`ReplicaFailure` propagates — it retires the worker, not
        the item.  Ordinary exceptions bump the replica's consecutive-
        failure count (a health-monitor death signal); successes reset it.
        """
        fn = self.stage_fns[i]
        seq, payload = envelope
        if isinstance(payload, _Failed):
            return envelope
        try:
            t0 = time.perf_counter()
            out = fn(payload)
            self._busy[i][slot] += time.perf_counter() - t0
            self._items[i][slot] += 1
            self._consec_fails[i][slot] = 0
        except ReplicaFailure:
            raise
        except BaseException as e:   # surface worker failures per item
            self._consec_fails[i][slot] += 1
            return (seq, _Failed(e))
        return (seq, out)

    def _apply_batched(self, i: int, slot: int,
                       bucket: List[Tuple[int, Any]]) -> List[Tuple[int, Any]]:
        """One stacked call over a same-signature bucket, split back into
        per-item envelopes.

        A stage *exception* falls back to per-item execution, which
        attributes the failure to the offending envelope(s).  A stage
        whose output does not split item-for-item along the leading axis
        is marked unstackable — this bucket runs per-item and later
        buckets skip aggregation entirely — so the stacked probe's wasted
        call happens at most once per stage.  Busy time is only credited
        for stacked calls whose result is actually used."""
        fn = self.stage_fns[i]
        payloads = [p for _, p in bucket]
        rows = [int(p.shape[0]) for p in payloads]
        parts = None
        try:
            xp = _array_namespace(payloads[0])
            t0 = time.perf_counter()
            stacked_out = fn(xp.concatenate(payloads, axis=0))
            dt = time.perf_counter() - t0
            out_shape = getattr(stacked_out, "shape", None)
            if out_shape is not None and int(out_shape[0]) == sum(rows):
                parts = []
                off = 0
                for r in rows:
                    parts.append(stacked_out[off:off + r])
                    off += r
            else:
                self._mb_unstackable[i] = True
        except ReplicaFailure:
            raise       # the replica died, not the bucket
        except BaseException:
            pass        # per-item rerun pins the failure to the right item
        if parts is None:
            return [self._apply(i, slot, env) for env in bucket]
        self._busy[i][slot] += dt
        self._items[i][slot] += len(bucket)
        self._mb_calls[i][slot] += 1
        self._mb_items[i][slot] += len(bucket)
        return [(seq, part) for (seq, _), part in zip(bucket, parts)]

    def _stage_loop(self, i: int, q_in: queue.Queue, q_out: queue.Queue,
                    slot: int, st: Optional[_StageState] = None) -> None:
        """Worker loop shared by plain stages and replica workers: FIFO in,
        FIFO out, optional same-signature micro-batching.

        Death semantics: a :class:`ReplicaFailure` out of the stage
        function retires this worker.  A replica of a replicated stage
        (``st`` given) re-dispatches its in-flight envelopes to a survivor
        and exits; the sole worker of an unreplicated stage switches to a
        *bypass* loop — it keeps draining its queue, forwarding every
        envelope as ``_Failed(StageLost)`` so the stream never stalls and
        shutdown still cascades."""
        k = self.microbatch[i]
        carry: Any = None
        while True:
            item = carry
            while item is None:
                try:
                    item = q_in.get(timeout=0.1)
                except queue.Empty:
                    # refresh the heartbeat while idle: a stale beat must
                    # mean "stuck inside the stage fn (or dead)", never
                    # "healthy but nothing to do"
                    self._beats[i][slot] = time.monotonic()
            carry = None
            if item is _SHUTDOWN:
                if st is None:
                    q_out.put(_SHUTDOWN)
                else:
                    self._emit_token(st, slot, _SHUTDOWN)
                return
            if item is _RETIRE:
                return          # killer reclaimed our queue + in-flight
            if self._dead[i][slot]:
                if st is not None:
                    return      # token + re-dispatch handled at kill time
                q_out.put((item[0], _Failed(StageLost(i, self.name))))
                continue
            self._beats[i][slot] = time.monotonic()
            bucket = [item]
            try:
                key = (_microbatch_key(item[1])
                       if k > 1 and not self._mb_unstackable[i] else None)
                if key is None:
                    q_out.put(self._apply(i, slot, item))
                    continue
                deadline: Optional[float] = None
                while len(bucket) < k:
                    try:
                        nxt = q_in.get_nowait()
                    except queue.Empty:
                        if self.microbatch_wait_s <= 0.0:
                            break
                        if deadline is None:
                            deadline = (time.monotonic()
                                        + self.microbatch_wait_s)
                        remaining = deadline - time.monotonic()
                        if remaining <= 0.0:
                            break
                        try:
                            nxt = q_in.get(timeout=remaining)
                        except queue.Empty:
                            break
                    if (nxt is _SHUTDOWN or nxt is _RETIRE
                            or _microbatch_key(nxt[1]) != key):
                        carry = nxt     # keep FIFO: process after bucket
                        break
                    bucket.append(nxt)
                if len(bucket) == 1:
                    q_out.put(self._apply(i, slot, item))
                else:
                    for env in self._apply_batched(i, slot, bucket):
                        q_out.put(env)
            except ReplicaFailure:
                self._dead[i][slot] = True
                if st is not None:
                    # in-hand envelopes (bucket + carry) are all in the
                    # in-flight registry with our slot: retire re-places
                    self._retire_replica(i, slot, st)
                    return
                # sole worker: fail what we hold, then bypass onward
                for env in bucket:
                    q_out.put((env[0], _Failed(StageLost(i, self.name))))
                self._fire_stage_lost(i)
                # carry (if any) is handled by the loop top: a _SHUTDOWN
                # forwards, an envelope fails fast through the dead check

    # -- failure domains ------------------------------------------------------
    def _emit_token(self, st: _StageState, slot: int, token: Any) -> None:
        """Each replica contributes exactly one termination token to its
        merge, whichever retires it first (drain or death)."""
        with st.lock:
            if st.token_emitted[slot]:
                return
            st.token_emitted[slot] = True
        st.mq.put(token)

    def _fire_stage_lost(self, i: int) -> None:
        with self._health_lock:
            if self._stage_lost_fired[i]:
                return
            self._stage_lost_fired[i] = True
        cb = self.on_stage_lost
        if cb is not None:
            try:
                cb(i)
            except Exception:       # observer bugs must not kill workers
                pass

    def _place(self, i: int, st: _StageState, seq: int,
               exclude: Optional[int] = None) -> None:
        """(Re-)dispatch an in-flight envelope onto a live replica of
        stage ``i``; with none left, fail it into the merge as
        ``StageLost`` so the stream keeps flowing.  Safe to call from the
        dispatcher, a dying worker, the hedge monitor, or an external
        killer — the registry record is the single source of truth and a
        seq whose record is gone (already emitted) is a no-op."""
        while True:
            with st.lock:
                rec = st.inflight.get(seq)
                if rec is None:
                    return          # already completed downstream
                live = [j for j in range(st.k)
                        if st.alive[j] and j != exclude]
                if not live:
                    st.inflight.pop(seq, None)
                    payload = rec.payload
                    j = None
                else:
                    j = live[st.rr % len(live)]
                    st.rr += 1
                    rec.slot = j
                    rec.t_dispatch = time.monotonic()
            if j is None:
                st.mq.put((seq, _Failed(StageLost(i, self.name))))
                self._fire_stage_lost(i)
                return
            try:
                st.wqs[j].put((seq, rec.payload), timeout=0.05)
            except queue.Full:
                continue            # re-check liveness, maybe new target
            # j may have died between the choice and the put: anything
            # stranded in its (now consumerless) queue gets re-placed
            with st.lock:
                died = not st.alive[j]
            if not died:
                return
            for stray in self._drain_queue(st.wqs[j]):
                if stray is _SHUTDOWN or stray is _RETIRE:
                    continue
                self._place(i, st, stray[0], exclude=j)
            return

    def _retire_replica(self, i: int, slot: int,
                        st: _StageState) -> None:
        """Retire one replica of a replicated stage: mark it dead, emit
        its termination token, reclaim its queue, and re-dispatch every
        envelope it had accepted but not emitted to a surviving replica
        (or fail them as StageLost when it was the last one)."""
        with st.lock:
            self._dead[i][slot] = True
            st.alive[slot] = False
            assigned = [seq for seq, rec in st.inflight.items()
                        if rec.slot == slot]
            none_alive = not any(st.alive)
        self._emit_token(st, slot, _DEAD_TOKEN)
        # reclaim the dead replica's queue (no consumer anymore) and nudge
        # a worker thread blocked on it out of its get()
        strays = [x[0] for x in self._drain_queue(st.wqs[slot])
                  if x is not _SHUTDOWN and x is not _RETIRE]
        try:
            st.wqs[slot].put_nowait(_RETIRE)
        except queue.Full:
            pass
        for seq in dict.fromkeys(assigned + strays):
            with st.lock:
                known = seq in st.inflight
                if known:
                    st.redispatches += 1
            if known:
                self._place(i, st, seq, exclude=slot)
        if none_alive:
            self._fire_stage_lost(i)

    @staticmethod
    def _drain_queue(q: queue.Queue) -> List[Any]:
        out = []
        while True:
            try:
                out.append(q.get_nowait())
            except queue.Empty:
                return out

    def kill_replica(self, stage: int, slot: int = 0) -> None:
        """Withdraw one replica (health monitor / chaos entry point): its
        in-flight envelopes are re-dispatched to surviving replicas; on an
        unreplicated stage this is a stage loss — subsequent envelopes
        fail fast as :class:`StageLost` (the item the worker is currently
        applying, if any, still completes normally)."""
        if not self._started:
            raise RuntimeError(f"{self.name}: not started")
        if not (0 <= stage < self.n_stages):
            raise ValueError(f"no stage {stage}")
        if not (0 <= slot < self.replicas[stage]):
            raise ValueError(f"stage {stage} has no replica {slot}")
        st = self._stage_states[stage]
        if st is None:
            self._dead[stage][slot] = True
            self._fire_stage_lost(stage)
            return
        self._retire_replica(stage, slot, st)

    def kill_stage(self, stage: int) -> None:
        """Withdraw every replica of a stage (the degraded-mode trigger)."""
        for slot in range(self.replicas[stage]):
            self.kill_replica(stage, slot)

    def _hedger(self) -> None:
        """Hedge monitor: an envelope still in flight ``hedge_after``
        seconds after dispatch is speculatively re-issued to a different
        live replica; the merge's dedup-by-sequence keeps the first
        result, so hedging never changes outputs — only tail latency."""
        interval = max(0.001, self.hedge_after / 4.0)
        while not self._hedge_stop.wait(interval):
            now = time.monotonic()
            for i, st in enumerate(self._stage_states):
                if st is None:
                    continue
                with st.lock:
                    stale = [seq for seq, rec in st.inflight.items()
                             if (not rec.hedged and rec.slot >= 0
                                 and now - rec.t_dispatch
                                 >= self.hedge_after)]
                for seq in stale:
                    self._hedge_one(i, st, seq)

    def _hedge_one(self, i: int, st: _StageState, seq: int) -> None:
        with st.lock:
            rec = st.inflight.get(seq)
            if rec is None or rec.hedged:
                return
            live = [j for j in range(st.k)
                    if st.alive[j] and j != rec.slot]
            if not live:
                return
            j = live[st.rr % len(live)]
            st.rr += 1
            payload = rec.payload
        try:
            st.wqs[j].put_nowait((seq, payload))
        except queue.Full:
            return                  # backpressured: retry next scan
        with st.lock:
            rec = st.inflight.get(seq)
            if rec is not None:
                rec.hedged = True
            st.hedges += 1

    def health_snapshot(self) -> Dict[str, Any]:
        """Failure-domain observability: per-replica liveness, heartbeat
        ages (seconds since the replica last started work), consecutive
        item-failure counts, and per-stage hedge / re-dispatch counters.
        All monotonic or idempotent — safe to poll from a monitor."""
        now = time.monotonic()
        return {
            "alive": [[not d for d in row] for row in self._dead],
            "live_replicas": [sum(1 for d in row if not d)
                              for row in self._dead],
            "heartbeat_age_s": [[now - b for b in row]
                                for row in self._beats],
            "consecutive_failures": [list(row)
                                     for row in self._consec_fails],
            "hedges": [st.hedges if st else 0
                       for st in self._stage_states],
            "redispatches": [st.redispatches if st else 0
                             for st in self._stage_states],
        }

    def _dispatcher(self, i: int, q_in: queue.Queue,
                    st: _StageState) -> None:
        """Fan one stage's input onto its replicas, registering every
        envelope in the stage's in-flight registry before it is placed —
        the registry is what failover re-dispatches from."""
        while True:
            item = q_in.get()
            if item is _SHUTDOWN:
                with st.lock:
                    targets = [j for j in range(st.k) if st.alive[j]]
                for j in targets:
                    while True:
                        with st.lock:
                            if not st.alive[j]:
                                break   # died while draining: _DEAD covers it
                        try:
                            st.wqs[j].put(_SHUTDOWN, timeout=0.05)
                            break
                        except queue.Full:
                            continue
                st.mq.put(_DISPATCHER_DONE)
                return
            with st.lock:
                st.inflight[item[0]] = _InFlight(item[1])
            self._place(i, st, item[0])

    def _merge(self, st: _StageState, q_out: queue.Queue) -> None:
        """Order-restoring, deduplicating fan-in: buffer out-of-order
        envelopes, emit by monotonic stream sequence, and drop duplicate
        results (hedged or re-issued envelopes may complete twice — the
        first one wins, which is what makes hedging/failover invisible
        downstream).

        ``next_seq`` advances for the executor's whole lifetime — there is
        no batch boundary to reset it at, which is what lets batches
        overlap in flight.  Termination: each of the ``k`` replicas emits
        exactly one token (_SHUTDOWN on drain, _DEAD_TOKEN on death); the
        merge forwards one _SHUTDOWN downstream once the dispatcher has
        drained *and* all ``k`` tokens arrived."""
        tokens = 0
        dispatcher_done = False
        buf: Dict[int, Any] = {}
        next_seq = 0
        while True:
            item = st.mq.get()
            if item is _DISPATCHER_DONE:
                dispatcher_done = True
            elif item is _SHUTDOWN or item is _DEAD_TOKEN:
                tokens += 1
            else:
                seq, payload = item
                with st.lock:
                    st.inflight.pop(seq, None)
                if seq < next_seq or seq in buf:
                    continue        # duplicate (hedge / failover re-issue)
                buf[seq] = payload
                while next_seq in buf:
                    q_out.put((next_seq, buf.pop(next_seq)))
                    next_seq += 1
            if dispatcher_done and tokens >= st.k:
                q_out.put(_SHUTDOWN)
                return

    def _collector(self, q_tail: queue.Queue,
                   pending: Dict[int, Any]) -> None:
        """Tail thread: complete each item's completion target as it exits
        the last stage — a Future (submit) gets the result or the original
        stage exception; a batch sink (run_batch) gets the raw payload."""
        while True:
            item = q_tail.get()
            if item is _SHUTDOWN:
                return
            seq, payload = item
            entry = pending.pop(seq, None)
            if entry is None:
                continue
            if isinstance(entry, Future):
                try:
                    if isinstance(payload, _Failed):
                        entry.set_exception(payload.error)
                    else:
                        entry.set_result(payload)
                except Exception:
                    pass    # already failed by a concurrent stop()
            else:
                sink, idx = entry
                sink.deliver(idx, payload)

    # -- accounting ----------------------------------------------------------
    def busy_snapshot(self) -> List[float]:
        """Monotonic per-stage busy seconds (summed over replicas).
        Measure an interval as the delta of two snapshots."""
        return [sum(slots) for slots in self._busy]

    def items_snapshot(self) -> List[int]:
        """Monotonic per-stage successfully-applied item counts (summed
        over replicas).  ``busy_snapshot`` delta / ``items_snapshot``
        delta = the interval's observed per-item stage time — the live
        telemetry the self-healing control loop feeds back into the
        planner's cost model (``runtime.selfheal``)."""
        return [sum(slots) for slots in self._items]

    def microbatch_snapshot(self) -> Dict[str, List[int]]:
        """Monotonic per-stage micro-batching counters (summed over
        replicas): stacked calls and the items they covered (items/calls
        = realized amortization)."""
        return {"calls": [sum(s) for s in self._mb_calls],
                "items": [sum(s) for s in self._mb_items]}

    # -- batches -------------------------------------------------------------
    def run_batch(self, inputs: Sequence[Any],
                  collect_stage_times: bool = False
                  ) -> Tuple[List[Any], Optional[List[float]]]:
        """Admit `inputs` into the stream and gather their futures; returns
        (outputs, stage_busy_s).

        Outputs preserve input order: unreplicated stages are in-order
        queues, replicated stages restore order at their merge, and futures
        are gathered in submission order, so the output list is identical
        to the historical batch-synchronous executor's.  If any stage
        raised, the first exception (in submission order) is re-raised
        after every item of the batch has drained (so the executor stays
        reusable).  ``stage_busy_s[i]`` is the busy_snapshot() delta across
        the batch — equal to the batch's own busy time when no other
        traffic interleaves.  Creates no threads and takes no barrier:
        another caller's items may flow through the same stream
        concurrently.
        """
        if not self._started:
            self.start()
        snap0 = self.busy_snapshot() if collect_stage_times else None
        items = list(inputs)
        n = len(items)
        outputs: List[Any] = []
        errors: List[BaseException] = []
        if n:
            # same admission as submit(), but completions land in one
            # shared batch sink (a slot per item + one Event) instead of a
            # Future each — the steady-state gather costs one lock op per
            # item, not a condition variable round-trip
            sink = _BatchSink(n)
            with self._submit_lock:
                if self._draining or not self._started:
                    raise RuntimeError(f"{self.name}: executor is stopping")
                seqs = [next(self._seq) for _ in range(n)]
                for idx, seq in enumerate(seqs):
                    self._pending[seq] = (sink, idx)
            q_in = self._queues[0]
            stranded = False
            for seq, x in zip(seqs, items):   # blocking puts: backpressure
                while not stranded:
                    try:
                        q_in.put((seq, x), timeout=0.1)
                        break
                    except queue.Full:
                        # a concurrent stop() may have shut the workers
                        # down under us: our registered entries get
                        # PipelineStopped from stop(), so bail out rather
                        # than block on a dead queue
                        stranded = self._draining or not self._started
                if stranded:
                    break
            sink.done.wait()
            for slot in sink.slots:
                payload = slot[0]
                if isinstance(payload, _Failed):
                    errors.append(payload.error)
                else:
                    outputs.append(payload)
        if errors:
            raise errors[0]
        busy = None
        if collect_stage_times and snap0 is not None:
            busy = [b - a for a, b in zip(snap0, self.busy_snapshot())]
        return outputs, busy

    def timed_run(self, inputs: Sequence[Any]) -> Tuple[List[Any], float, List[float]]:
        t0 = time.perf_counter()
        outs, busy = self.run_batch(inputs, collect_stage_times=True)
        return outs, time.perf_counter() - t0, busy or []


def simulated_stage(latency_s: float) -> Callable[[Any], Any]:
    """A stage that just sleeps — used to validate the pipeline time model.

    Zero latency skips the sleep syscall entirely (``time.sleep(0)`` still
    forces a scheduler yield per item, which would swamp executor-overhead
    measurements)."""
    if latency_s <= 0.0:
        return lambda x: x
    def fn(x: Any) -> Any:
        time.sleep(latency_s)
        return x
    return fn


def stage_balance_metrics(stage_times: Sequence[float]) -> dict:
    """Paper Fig. 10 metrics: slowest stage time and deviation from mean.

    An empty sequence (e.g. a snapshot interval in which no stage ran)
    yields the neutral record rather than raising."""
    if not stage_times:
        return {"max_stage_s": 0.0, "mean_stage_s": 0.0,
                "max_minus_mean_s": 0.0, "balance": 1.0}
    mx = max(stage_times)
    mean = sum(stage_times) / len(stage_times)
    return {"max_stage_s": mx, "mean_stage_s": mean,
            "max_minus_mean_s": mx - mean,
            "balance": mean / mx if mx > 0 else 1.0}


def _shape_key(x: Any) -> Any:
    """Hashable signature of a stage input: (shape, dtype) for arrays."""
    shape = getattr(x, "shape", None)
    if shape is not None:
        return (tuple(shape), str(getattr(x, "dtype", "")))
    return type(x).__name__


def _microbatch_key(payload: Any) -> Optional[Any]:
    """Bucketing key for dynamic micro-batching, or None when the payload
    cannot join a stacked call: failed envelopes forward untouched, and
    only array payloads with a leading (batch) axis stack."""
    if isinstance(payload, _Failed):
        return None
    shape = getattr(payload, "shape", None)
    if shape is None or len(shape) == 0 or not hasattr(payload, "dtype"):
        return None
    return (tuple(shape), str(payload.dtype))


def _array_namespace(x: Any):
    """torch for tensors, so stacking stays on the tensor's device; numpy
    for numpy arrays and as the generic fallback."""
    import numpy as np
    import torch
    if isinstance(x, torch.Tensor):
        return torch
    return np


class ShapeKeyedStageCache:
    """Memoize built (typically jitted) stage callables per input signature.

    Stage builders close over sliced parameters and ``jax.jit`` wrappers;
    rebuilding them per server restart (or eagerly for shapes never served)
    wastes startup time and tracing.  ``get(name, x, build)`` builds the
    stage callable at most once per (stage name, input shape/dtype) and
    returns the cached callable afterwards, so steady-state batches reuse
    the already-traced function.  Micro-batched stages compose naturally:
    the stacked array is just another signature, so each realized bucket
    size gets its own traced callable.
    """

    def __init__(self) -> None:
        self._fns: Dict[Any, Callable[[Any], Any]] = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._fns)

    def get(self, name: str, x: Any,
            build: Callable[[], Callable[[Any], Any]]) -> Callable[[Any], Any]:
        key = (name, _shape_key(x))
        fn = self._fns.get(key)
        if fn is None:
            with self._lock:
                fn = self._fns.get(key)
                if fn is None:
                    fn = self._fns[key] = build()
        return fn

    def wrap(self, name: str,
             build: Callable[[], Callable[[Any], Any]]) -> Callable[[Any], Any]:
        """A stage function that lazily builds/caches per input signature."""
        def stage(x: Any) -> Any:
            return self.get(name, x, build)(x)
        return stage
