"""Admission front door: one ``submit()`` for N member servers.

The router is the only thing a fleet client sees — ``submit(model,
payload) -> Request`` — and it owns the *cross-model* fairness decision
the per-model servers cannot make: which member's queue gets the next
dispatch slot.  It runs **deficit round-robin** (DRR) weighted fair
queueing on member ``share``: each sweep credits every backlogged member
``share_i / min_share`` dispatch credits and drains whole requests while
credit lasts, so over any backlogged interval member throughput
converges to the share ratio without starving anyone (a member's unused
credit dies with its empty queue, per classic DRR).

Everything *below* the dispatch decision reuses the server's overload
machinery unchanged: a routed request carries an absolute deadline fixed
at submit time; the remaining budget is recomputed at dispatch and
handed to the member server's own ``submit(deadline_s=)``, so the
member-side shed/deadline logic (pace-EWMA queue-delay estimate,
``Overloaded`` with jittered ``retry_after_s``, merge-exit
``DeadlineExceeded``) applies per model with its own policy.  A request
that dies *in the router queue* completes with ``DeadlineExceeded`` at
``"router"`` — the queue wait is charged against the same budget, never
hidden.  Completion chains back through ``Request.on_done`` (no polling
thread per request).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..core.pipeline import PipelineStopped
from ..serving.server import (DeadlineExceeded, PipelinedModelServer,
                              Request, _RID)

ServerSupplier = Callable[[], Optional[PipelinedModelServer]]


class FleetRouter:
    """Weighted-fair admission over per-member servers.

    ``servers`` maps member name -> supplier returning that member's
    *current* live server (suppliers, not servers: the autoscaler
    hot-swaps plans inside a server, and the fleet may cycle servers —
    the router always dispatches to whatever is live now).
    ``shares`` maps member name -> DRR weight; ``deadlines_s`` member
    name -> default relative deadline budget (``None`` = none).
    """

    def __init__(self, servers: Dict[str, ServerSupplier],
                 shares: Dict[str, float],
                 deadlines_s: Optional[Dict[str, Optional[float]]] = None):
        if set(servers) != set(shares):
            raise ValueError("servers and shares must cover the same "
                             "member names")
        if not servers:
            raise ValueError("router needs at least one member")
        for name, s in shares.items():
            if s <= 0:
                raise ValueError(f"member {name!r}: share must be > 0")
        self._servers = dict(servers)
        self._shares = dict(shares)
        self._deadlines = dict(deadlines_s or {})
        self._names = sorted(servers)       # fixed sweep order
        min_share = min(self._shares.values())
        self._quantum = {n: self._shares[n] / min_share
                         for n in self._names}
        self._deficit = {n: 0.0 for n in self._names}
        self._queues: Dict[str, deque] = {n: deque() for n in self._names}
        self._cv = threading.Condition()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stats_lock = threading.Lock()
        self.stats: Dict[str, Dict[str, int]] = {
            n: {"submitted": 0, "dispatched": 0, "completed": 0,
                "failed": 0, "expired_in_router": 0}
            for n in self._names}

    # -- client API ----------------------------------------------------------
    def submit(self, model: str, payload: Any,
               deadline_s: Optional[float] = None,
               on_done: Optional[Callable[[Request], None]] = None
               ) -> Request:
        """Enqueue a request for ``model``.  The deadline budget (explicit
        or the member default) becomes absolute *now* — router queueing
        spends it just like server queueing does.  ``on_done`` is
        installed before the request can complete (attaching it to the
        returned object instead would race the dispatch thread)."""
        if model not in self._queues:
            raise KeyError(f"no fleet member {model!r}; members: "
                           f"{self._names}")
        req = Request(rid=next(_RID), payload=payload, on_done=on_done)
        budget = (deadline_s if deadline_s is not None
                  else self._deadlines.get(model))
        if budget is not None:
            req.deadline_s = req.t_submit + budget
        with self._stats_lock:
            self.stats[model]["submitted"] += 1
        with self._cv:
            if self._stop_evt.is_set():
                self._complete(model, req, None,
                               PipelineStopped("router stopped"))
                return req
            self._queues[model].append(req)
            self._cv.notify()
        return req

    # -- dispatch loop -------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fleet-router")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop_evt.is_set():
            with self._cv:
                while (not self._stop_evt.is_set()
                       and not any(self._queues[n] for n in self._names)):
                    self._cv.wait(timeout=0.1)
                if self._stop_evt.is_set():
                    return
                batch = self._drr_sweep()
            # dispatch outside the lock: server.submit only enqueues into
            # the member batcher, but it must not serialize new arrivals
            for name, req in batch:
                self._dispatch(name, req)

    def _drr_sweep(self) -> List:
        """One DRR round over backlogged members (caller holds the cv
        lock).  Returns [(member, request), ...] in dispatch order."""
        out = []
        for name in self._names:
            q = self._queues[name]
            if not q:
                self._deficit[name] = 0.0   # classic DRR: no banking
                continue
            self._deficit[name] += self._quantum[name]
            while q and self._deficit[name] >= 1.0:
                self._deficit[name] -= 1.0
                out.append((name, q.popleft()))
        return out

    def _dispatch(self, name: str, req: Request) -> None:
        now = time.perf_counter()
        if req.deadline_s is not None and now >= req.deadline_s:
            self._complete(name, req, None, DeadlineExceeded(
                req.rid, now - req.deadline_s, "router"))
            return
        srv = self._servers[name]()
        if srv is None or srv.stopped:
            self._complete(name, req, None, PipelineStopped(
                f"member {name!r} has no live server"))
            return
        remaining = (None if req.deadline_s is None
                     else req.deadline_s - now)
        try:
            inner = srv.submit(req.payload, deadline_s=remaining)
        except Exception as e:
            self._complete(name, req, None, e)
            return
        with self._stats_lock:
            self.stats[name]["dispatched"] += 1
        inner.on_done = (lambda ireq, n=name, r=req:
                         self._complete(n, r, ireq.result, ireq.error))
        # the inner request may have fully completed between submit()
        # returning and the hook landing — the member's collector would
        # then never see on_done, so finish the chain here (idempotent:
        # _complete no-ops on an already-completed router request)
        if inner.event.is_set():
            self._complete(name, req, inner.result, inner.error)

    def _complete(self, name: str, req: Request, result: Any,
                  error: Optional[BaseException]) -> None:
        with self._stats_lock:
            if req.t_done is not None:      # already completed (hook +
                return                      # completed-early fallback)
            req.result = result
            req.error = error
            req.t_done = time.perf_counter()
            if error is None:
                self.stats[name]["completed"] += 1
            else:
                self.stats[name]["failed"] += 1
                if (isinstance(error, DeadlineExceeded)
                        and error.where == "router"):
                    self.stats[name]["expired_in_router"] += 1
        req.event.set()
        if req.on_done is not None:
            try:
                req.on_done(req)
            except Exception:
                pass

    # -- accounting / lifecycle ----------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Router-side counters and queue depths per member (cumulative —
        the delta view lives in the member servers' own snapshots)."""
        with self._stats_lock:
            counters = {n: dict(c) for n, c in self.stats.items()}
        with self._cv:
            depths = {n: len(self._queues[n]) for n in self._names}
        return {"members": counters, "queue_depth": depths,
                "shares": dict(self._shares)}

    def stop(self) -> None:
        """Stop dispatching; requests still queued in the router complete
        with :class:`PipelineStopped` (never silently dropped)."""
        with self._cv:
            self._stop_evt.set()
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        leftovers = []
        with self._cv:
            for name in self._names:
                while self._queues[name]:
                    leftovers.append((name, self._queues[name].popleft()))
        for name, req in leftovers:
            self._complete(name, req, None,
                           PipelineStopped("router stopped before "
                                           "dispatch"))

    def __enter__(self) -> "FleetRouter":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
