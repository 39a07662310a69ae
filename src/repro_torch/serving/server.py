"""Streaming request serving over the segmented pipeline.

This is the paper's deployment shape (§5.1): "it is common to have several
data sources gathering data at once that allow forming a small batch for
each read period (e.g., many cameras for object detection)" — extended from
batch-synchronous to *continuous admission*: requests flow from the batcher
straight into the executor's stream (``PipelineExecutor.submit``), so the
pipeline never drains and refills at a batch boundary and every stage stays
fed under load.

* :class:`MicroBatcher` — gathers requests into a batch of up to
  ``max_batch``, waiting at most ``max_wait_s`` from *entry* (latency
  bound).  Under the streaming server this bounds admission-loop wakeups,
  not pipeline occupancy: admitted requests overlap in flight regardless
  of which gather window they arrived in.
* :class:`PipelinedModelServer` — a PlacementPlan + per-stage functions
  (from GraphModel.apply_subset or the LM stage executor) over a persistent
  streaming executor.  An admission thread moves requests from the batcher
  into the stream; each request's future completes it individually
  (``Request.event`` / ``Request.result`` / ``Request.error``) with
  per-request latency recorded.  Busy-time and request accounting are
  monotonic counters; :meth:`PipelinedModelServer.snapshot` returns deltas
  (throughput, per-stage busy seconds, latency percentiles) since the last
  snapshot.  Replicated stages in the plan (``replicas > 1``) map onto the
  executor's round-robin fan-out — the stage function is shared by k
  workers, so it must be thread-safe (jitted JAX callables are) — and
  ``microbatch`` enables the executor's shape-bucketed dynamic
  micro-batching for accelerator stages.  The elastic hook
  (:meth:`reconfigure`, driven by ``runtime.ft.ElasticPlanner``) drains
  in-flight work and hot-swaps the plan + stage functions when the device
  pool resizes.

  Fault tolerance: within a replicated stage, replica death is absorbed
  by the executor (in-flight re-dispatch — requests never notice).  When
  a stage loses its *last* replica its requests fail fast as
  :class:`~repro_torch.core.pipeline.StageLost`; with ``stage_loss_retries > 0``
  the server re-admits them through the batcher instead of failing them,
  so they are served by whatever plan is live once the degraded-mode
  replan (``runtime.ft.HealthMonitor`` → ``ElasticPlanner.resize_server``
  → :meth:`reconfigure`) lands.  ``hedge_after`` enables the executor's
  hedged dispatch on replicated stages.  Stage-lost events fan out to
  listeners registered via :meth:`add_stage_lost_listener` (re-wired
  automatically across reconfigure swaps).

  Overload protection: per-request **deadlines** — a request
  carries an absolute deadline (``deadline_ms`` server default, or per
  ``submit``); one that is already past due at admission, or whose result
  exits the merge after its deadline, is completed with
  :class:`DeadlineExceeded` instead of waiting (or returning) unbounded —
  a request is *never* silently stuck.  **Admission control** — with
  ``shed_policy="deadline"`` the admission loop estimates queue delay as
  ``executor.in_flight x pace`` (pace = EWMA of inter-completion gaps
  while the pipeline is saturated) and *sheds* a request whose estimated
  completion would outlive its deadline, completing it immediately with
  :class:`Overloaded` carrying a ``retry_after_s`` hint — jittered
  exponential backoff over consecutive sheds (seeded: deterministic in
  tests), reset on the first successful admission.  Shed/deadline counts
  ride the same monotonic stats stream (:meth:`snapshot` deltas).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import queue
import random
import threading
import time
from collections import deque
from typing import (Any, Callable, Dict, List, Optional, Sequence, Union)

from ..core.pipeline import PipelineExecutor, PipelineStopped, StageLost
from ..core.placement import PlacementPlan

# process-wide request ids: ``id(payload)`` collided when payload objects
# were reused (or GC'd and their addresses recycled) across requests
_RID = itertools.count()


class DeadlineExceeded(RuntimeError):
    """Completion error for a request that outlived its deadline — either
    already past due at admission (it sat in the batcher too long) or its
    result exited the merge after the deadline.  Either way the request
    *completes* (event set, error recorded); it is never silently stuck."""

    def __init__(self, rid: int, overshoot_s: float, where: str):
        super().__init__(f"request {rid} exceeded its deadline by "
                         f"{overshoot_s * 1e3:.1f} ms ({where})")
        self.rid = rid
        self.overshoot_s = overshoot_s
        self.where = where


class Overloaded(RuntimeError):
    """Completion error for a request shed at admission: the estimated
    queue delay would outlive its deadline budget.  Carries
    ``retry_after_s`` — a jittered exponential-backoff hint that grows
    with consecutive sheds, so synchronized callers spread their
    retries instead of stampeding the recovering server."""

    def __init__(self, rid: int, retry_after_s: float,
                 queue_delay_est_s: float):
        super().__init__(f"request {rid} shed at admission "
                         f"(queue-delay estimate "
                         f"{queue_delay_est_s * 1e3:.1f} ms past deadline); "
                         f"retry after {retry_after_s * 1e3:.0f} ms")
        self.rid = rid
        self.retry_after_s = retry_after_s
        self.queue_delay_est_s = queue_delay_est_s


@dataclasses.dataclass
class Request:
    rid: int
    payload: Any
    t_submit: float = dataclasses.field(default_factory=time.perf_counter)
    result: Any = None
    error: Optional[BaseException] = None
    retries: int = 0          # stage-loss re-admissions of this request
    t_done: Optional[float] = None
    deadline_s: Optional[float] = None    # absolute (perf_counter) deadline
    event: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    # completion observer, invoked after the event is set (the fleet
    # router chains member-server completions back to its own requests
    # this way); must not block — it runs on the executor's collector
    on_done: Optional[Callable[["Request"], None]] = None

    @property
    def latency(self) -> float:
        return (self.t_done or time.perf_counter()) - self.t_submit


class MicroBatcher:
    def __init__(self, max_batch: int = 15, max_wait_s: float = 0.02):
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.q: "queue.Queue[Request]" = queue.Queue()

    def submit(self, payload: Any, rid: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Request:
        req = Request(rid=rid if rid is not None else next(_RID),
                      payload=payload)
        if deadline_s is not None:
            req.deadline_s = req.t_submit + deadline_s
        self.q.put(req)
        return req

    def next_batch(self, block: bool = True) -> List[Request]:
        # the deadline starts at entry: the wait for the *first* request
        # counts against it, so the worst case is max_wait_s, not 2x
        deadline = time.perf_counter() + self.max_wait_s
        batch: List[Request] = []
        try:
            batch.append(self.q.get(block=block, timeout=self.max_wait_s))
        except queue.Empty:
            return batch
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self.q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch


def latency_percentiles(latencies_s: Sequence[float]) -> Dict[str, float]:
    """p50/p95/p99 (+ mean/max) of a latency sample, in seconds.
    Empty samples yield an all-zero record."""
    if not latencies_s:
        return {"n": 0, "p50_s": 0.0, "p95_s": 0.0, "p99_s": 0.0,
                "mean_s": 0.0, "max_s": 0.0}
    xs = sorted(latencies_s)
    n = len(xs)

    def pct(p: float) -> float:
        # nearest-rank: smallest x with at least p*n samples <= x
        return xs[min(n - 1, max(0, math.ceil(p * n) - 1))]

    return {"n": n, "p50_s": pct(0.50), "p95_s": pct(0.95),
            "p99_s": pct(0.99), "mean_s": sum(xs) / n, "max_s": xs[-1]}


class PipelinedModelServer:
    """Serve a continuous request stream through the stage pipeline of a
    plan.

    Owns a *persistent streaming* :class:`PipelineExecutor`: stage worker
    threads and queues are created once; requests are admitted into the
    stream as they arrive (no inter-batch barrier) and completed
    individually by the executor's collector.  Use as a context manager
    (or call :meth:`stop`) for a clean shutdown — in-flight requests are
    then completed with :class:`PipelineStopped` rather than left hanging.
    """

    def __init__(self, plan: PlacementPlan,
                 stage_fns: Sequence[Callable[[Any], Any]],
                 max_batch: int = 15, max_wait_s: float = 0.02,
                 queue_size: int = 64,
                 microbatch: Optional[Union[int, Sequence[int]]] = None,
                 microbatch_wait_s: float = 0.0,
                 hedge_after: Optional[float] = None,
                 stage_loss_retries: int = 0,
                 latency_window: int = 4096,
                 deadline_s: Optional[float] = None,
                 shed_policy: str = "none",
                 backoff_base_s: float = 0.05,
                 backoff_max_s: float = 2.0,
                 backoff_seed: int = 0):
        assert len(stage_fns) == plan.n_stages
        if stage_loss_retries < 0:
            raise ValueError("stage_loss_retries must be >= 0")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be > 0 (or None)")
        if shed_policy not in ("none", "deadline"):
            raise ValueError(f"unknown shed_policy {shed_policy!r} "
                             f"(expected 'none' or 'deadline')")
        if backoff_base_s <= 0 or backoff_max_s < backoff_base_s:
            raise ValueError("need 0 < backoff_base_s <= backoff_max_s")
        self.plan = plan
        self.stage_fns = list(stage_fns)
        self.queue_size = queue_size
        self.microbatch = microbatch
        self.microbatch_wait_s = microbatch_wait_s
        self.hedge_after = hedge_after
        self.stage_loss_retries = stage_loss_retries
        self.deadline_s = deadline_s
        self.shed_policy = shed_policy
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        # service pace: EWMA of inter-completion gaps observed while the
        # pipeline still holds work (saturated => gap == service pace);
        # queue-delay estimate for admission control = in_flight * pace
        self._pace_ewma: Optional[float] = None
        self._pace_alpha = 0.2
        self._last_done_t: Optional[float] = None
        self._consec_sheds = 0
        self._backoff_rng = random.Random(backoff_seed)
        self._stage_lost_listeners: List[Callable[[int], None]] = []
        self.executor = self._make_executor(plan, self.stage_fns)
        self.batcher = MicroBatcher(max_batch, max_wait_s)
        self._stop_evt = threading.Event()
        self._admission = threading.Lock()   # held to pause admission
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        # monotonic counters; read intervals via snapshot() deltas
        self.stats: Dict[str, Any] = {"batches": 0, "requests": 0,
                                      "admitted": 0,
                                      "completed": 0, "failed": 0,
                                      "retried": 0, "shed": 0,
                                      "deadline_exceeded": 0}
        self._stats_lock = threading.Lock()
        self._t_start = time.perf_counter()
        # executor item counters reset on reconfigure(); the lifetime
        # total rebases over the retired epochs so snapshot()'s ``totals``
        # block stays monotonic across hot-swaps
        self._items_epoch_base = 0
        self._recent_lat: deque = deque(maxlen=latency_window)
        self._window_lat: List[float] = []
        self._snap_state = {"t": time.perf_counter(),
                            "busy": self.executor.busy_snapshot(),
                            "items": self.executor.items_snapshot(),
                            "requests": 0, "completed": 0, "failed": 0,
                            "retried": 0, "shed": 0,
                            "deadline_exceeded": 0}

    def _make_executor(self, plan: PlacementPlan,
                       stage_fns: Sequence[Callable[[Any], Any]]
                       ) -> PipelineExecutor:
        ex = PipelineExecutor.for_plan(
            plan, stage_fns, queue_size=self.queue_size,
            microbatch=self.microbatch,
            microbatch_wait_s=self.microbatch_wait_s,
            hedge_after=self.hedge_after,
            name_prefix="serve")
        # every executor epoch (initial + each reconfigure swap) reports
        # stage losses to the same listeners (HealthMonitor et al.)
        ex.on_stage_lost = self._notify_stage_lost
        return ex

    def add_stage_lost_listener(self, cb: Callable[[int], None]) -> None:
        """Register an observer for last-replica-of-a-stage losses.
        Called from executor threads — observers must not block (enqueue
        and return; ``runtime.ft.HealthMonitor`` does exactly that)."""
        self._stage_lost_listeners.append(cb)

    def _notify_stage_lost(self, stage: int) -> None:
        for cb in list(self._stage_lost_listeners):
            try:
                cb(stage)
            except Exception:
                pass

    def __enter__(self) -> "PipelinedModelServer":
        self.executor.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- synchronous API ------------------------------------------------------
    def serve_batch(self, payloads: Sequence[Any]) -> List[Any]:
        """Admit a whole batch and wait for it (the paper's §5.1 camera
        read): outputs in submission order, first error re-raised after the
        batch drains.  Counts toward the same monotonic stats stream.
        Admission happens under the admission lock so a concurrent
        :meth:`reconfigure` cannot stop the executor under our feet; the
        wait happens outside it so the admission loop keeps flowing."""
        with self._admission:
            futures = [self.executor.submit(p) for p in payloads]
        with self._stats_lock:
            self.stats["admitted"] += len(futures)
        outputs: List[Any] = []
        errors: List[BaseException] = []
        done = 0
        for fut in futures:
            try:
                outputs.append(fut.result())
                done += 1
            except BaseException as e:
                errors.append(e)
        with self._stats_lock:
            self.stats["batches"] += 1
            self.stats["requests"] += len(payloads)
            self.stats["completed"] += done
            self.stats["failed"] += len(errors)
        if errors:
            raise errors[0]
        return outputs

    # -- streaming API -------------------------------------------------------
    def start(self) -> None:
        """Start the admission loop: requests flow from the batcher into
        the executor's stream as they arrive."""
        if self._thread is not None:
            return
        self._stop_evt.clear()

        def loop():
            while not self._stop_evt.is_set():
                batch = self.batcher.next_batch()
                if not batch:
                    continue
                with self._admission:
                    for req in batch:
                        self._admit(req)

        self._thread = threading.Thread(
            target=loop, daemon=True,
            name=f"serve-{self.plan.graph_name}-admit")
        self._thread.start()

    def submit(self, payload: Any,
               deadline_s: Optional[float] = None) -> Request:
        """Enqueue a request.  ``deadline_s`` is a relative budget from
        submit time (falls back to the server default); a request past its
        deadline completes with :class:`DeadlineExceeded`, never hangs."""
        budget = deadline_s if deadline_s is not None else self.deadline_s
        return self.batcher.submit(payload, deadline_s=budget)

    def _retry_after_s(self) -> float:
        """Jittered exponential backoff hint over consecutive sheds.
        Seeded rng => deterministic sequences in tests."""
        base = min(self.backoff_max_s,
                   self.backoff_base_s * (2.0 ** self._consec_sheds))
        return base * (1.0 + 0.25 * self._backoff_rng.random())

    def _admit(self, req: Request) -> None:
        now = time.perf_counter()
        if req.deadline_s is not None:
            if now >= req.deadline_s:
                # dead on arrival (sat in the batcher past its budget)
                self._finish(req, None, DeadlineExceeded(
                    req.rid, now - req.deadline_s, "admission"))
                return
            if (self.shed_policy == "deadline"
                    and self._pace_ewma is not None):
                est = self.executor.in_flight * self._pace_ewma
                if now + est > req.deadline_s:
                    retry_after = self._retry_after_s()
                    self._consec_sheds += 1
                    self._finish(req, None, Overloaded(
                        req.rid, retry_after, est))
                    return
        try:
            fut = self.executor.submit(req.payload)
        except RuntimeError as e:       # executor stopping under our feet
            self._finish(req, None, PipelineStopped(str(e)))
            return
        with self._stats_lock:
            self.stats["admitted"] += 1
        self._consec_sheds = 0          # admitted: reset backoff ladder
        fut.add_done_callback(
            lambda f, r=req: self._on_done(r, f))

    def _on_done(self, req: Request, fut) -> None:
        try:
            result = fut.result()
        except BaseException as e:
            # a request that crossed a dead stage is not lost: re-admit it
            # through the batcher so it is served by whatever plan is live
            # after the degraded-mode replan (reconfigure holds admission
            # while it swaps, so queued retries land on the new executor)
            if (isinstance(e, StageLost)
                    and req.retries < self.stage_loss_retries
                    and not self._stopped):
                req.retries += 1
                with self._stats_lock:
                    self.stats["retried"] += 1
                self.batcher.q.put(req)
                return
            self._finish(req, None, e)
            return
        if (req.deadline_s is not None
                and time.perf_counter() > req.deadline_s):
            # result arrived, but past due: complete with the deadline
            # error so the caller's wait is bounded and honest
            self._finish(req, None, DeadlineExceeded(
                req.rid, time.perf_counter() - req.deadline_s, "merge"))
            return
        self._finish(req, result, None)

    def _finish(self, req: Request, result: Any,
                error: Optional[BaseException]) -> None:
        req.result = result
        req.error = error
        req.t_done = time.perf_counter()
        lat = req.t_done - req.t_submit
        with self._stats_lock:
            self.stats["requests"] += 1
            if error is None:
                self.stats["completed"] += 1
                # pace signal: while the pipeline still holds work the gap
                # between completions is the service pace (saturated); an
                # idle-gap sample would poison the queue-delay estimate
                if (self._last_done_t is not None
                        and self.executor.in_flight > 0):
                    gap = req.t_done - self._last_done_t
                    if gap > 0:
                        self._pace_ewma = (
                            gap if self._pace_ewma is None else
                            self._pace_alpha * gap
                            + (1 - self._pace_alpha) * self._pace_ewma)
                self._last_done_t = req.t_done
            else:
                self.stats["failed"] += 1
                if isinstance(error, Overloaded):
                    self.stats["shed"] += 1
                elif isinstance(error, DeadlineExceeded):
                    self.stats["deadline_exceeded"] += 1
            if not isinstance(error, (Overloaded, DeadlineExceeded)):
                # shed/expired latencies are not service latencies
                self._recent_lat.append(lat)
                self._window_lat.append(lat)
        req.event.set()
        if req.on_done is not None:
            try:
                req.on_done(req)
            except Exception:
                pass            # an observer must never break completion

    # -- accounting ----------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Deltas since the previous snapshot: requests finished,
        throughput, per-stage busy seconds, and latency percentiles over
        the interval's completed requests.  Counters stay monotonic — this
        is the only reset-free way to watch a continuous stream.

        Taken under the admission lock so a concurrent :meth:`reconfigure`
        cannot swap the executor between reading its busy counters and
        rebasing ``_snap_state`` (which would yield negative deltas)."""
        with self._admission:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> Dict[str, Any]:
        now = time.perf_counter()
        busy = self.executor.busy_snapshot()
        items = self.executor.items_snapshot()
        with self._stats_lock:
            window = self._window_lat
            self._window_lat = []
            requests = self.stats["requests"]
            admitted = self.stats["admitted"]
            completed = self.stats["completed"]
            failed = self.stats["failed"]
            retried = self.stats["retried"]
            shed = self.stats["shed"]
            deadline_exceeded = self.stats["deadline_exceeded"]
        prev = self._snap_state
        dt = now - prev["t"]
        done = requests - prev["requests"]
        busy_d = [b - a for a, b in zip(prev["busy"], busy)]
        items_d = [b - a for a, b in
                   zip(prev.get("items", items), items)]
        # every field below is neutral (0 / 0.0 / empty-sample record) on
        # an empty delta window — a zero-completion interval must never
        # crash or emit NaN (latency_percentiles handles the empty sample)
        snap = {
            "dt_s": dt,
            "requests": done,
            "completed": completed - prev.get("completed", 0),
            "failed": failed - prev["failed"],
            "retried": retried - prev.get("retried", 0),
            "shed": shed - prev.get("shed", 0),
            "deadline_exceeded": (deadline_exceeded
                                  - prev.get("deadline_exceeded", 0)),
            "throughput_rps": (done / dt) if dt > 0 else 0.0,
            "stage_busy_s": busy_d,
            "stage_items": items_d,
            # per-item observed stage time — the live-telemetry signal the
            # self-healing loop (runtime.selfheal) refits the cost model
            # from; 0.0 (not NaN) for stages that applied nothing
            "stage_time_per_req_s": [
                (b / n) if n > 0 else 0.0
                for b, n in zip(busy_d, items_d)],
            "queue_depth": self.batcher.q.qsize(),
            "in_flight": self.executor.in_flight,
            "latency": latency_percentiles(window),
            # lifetime view alongside the delta view: cumulative counters
            # since construction (server-level counters survive
            # reconfigure() by construction; the executor item total is
            # rebased across epochs).  The fleet autoscaler folds these
            # into SLO headroom; ops dashboards read them directly.
            "totals": {
                "admitted": admitted,
                "requests": requests,
                "completed": completed,
                "failed": failed,
                "retried": retried,
                "shed": shed,
                "deadline_exceeded": deadline_exceeded,
                "stage_items": self._items_epoch_base + sum(items),
                "uptime_s": now - self._t_start,
            },
        }
        self._snap_state = {"t": now, "busy": busy, "items": items,
                            "requests": requests, "completed": completed,
                            "failed": failed, "retried": retried,
                            "shed": shed,
                            "deadline_exceeded": deadline_exceeded}
        return snap

    # -- elastic hook --------------------------------------------------------
    def reconfigure(self, plan: PlacementPlan,
                    stage_fns: Sequence[Callable[[Any], Any]],
                    drain_timeout: float = 30.0) -> None:
        """Hot-swap the plan + stage functions (elastic resize): pause
        admission, let in-flight requests drain, then replace the executor.
        Requests still queued in the batcher are served by the new plan."""
        assert len(stage_fns) == plan.n_stages
        with self._admission:
            deadline = time.monotonic() + drain_timeout
            while (self.executor.in_flight
                   and time.monotonic() < deadline):
                time.sleep(0.001)
            # fold the retiring epoch's item counters into the lifetime
            # total before its counters are lost with the executor
            self._items_epoch_base += sum(self.executor.items_snapshot())
            self.executor.stop(
                timeout=max(0.1, deadline - time.monotonic()))
            self.plan = plan
            self.stage_fns = list(stage_fns)
            self.executor = self._make_executor(plan, self.stage_fns)
            self.executor.start()
            # rebase busy/items deltas onto the new executor's counters
            self._snap_state["busy"] = self.executor.busy_snapshot()
            self._snap_state["items"] = self.executor.items_snapshot()
            # the new plan invalidates the old service-pace signal
            self._pace_ewma = None
            self._last_done_t = None

    @property
    def stopped(self) -> bool:
        """True once :meth:`stop` ran — a lifecycle owner (e.g. the
        ``repro_torch.api.Deployment`` handle) must treat this server as dead."""
        return self._stopped

    def stop(self) -> None:
        """Stop the admission loop and shut down the stage workers.
        In-flight requests complete with :class:`PipelineStopped`;
        never-admitted requests still waiting in the batcher do too."""
        self._stopped = True
        self._stop_evt.set()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None
        self.executor.stop()
        while True:
            try:
                req = self.batcher.q.get_nowait()
            except queue.Empty:
                break
            self._finish(req, None,
                         PipelineStopped("server stopped before admission"))

    close = stop
