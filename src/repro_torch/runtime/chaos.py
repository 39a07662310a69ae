"""Chaos harness for the streaming pipeline's fault-tolerance tier.

Kills workers/replicas/stages under open-loop load with *deterministic
seeds* and checks the executor's exactly-once contract:

* zero lost requests — every submitted request's future resolves (a value
  or a ``StageLost`` error; nothing hangs, nothing vanishes);
* zero misordered outputs — a tap stage appended after the user stages
  records the order results exit the pipeline, which must equal
  submission order (the order-restoring merge's dedup-by-sequence makes
  failover re-dispatch and hedged duplicates invisible downstream);
* bounded p99 inflation — latency percentiles per scenario, to compare
  with a no-fault baseline.

Pieces: :func:`replica_kill_schedule` (seeded kill plans that can spare
the last replica of every stage, or not — stage loss is a scenario too),
:class:`ChaosMonkey` (a thread that executes a schedule against a live —
possibly hot-swapped — executor), and :func:`run_chaos_executor` (one
open-loop run → :class:`ChaosReport`).
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core.pipeline import PipelineExecutor


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault: at ``at_s`` seconds into the run, kill
    ``stage``'s replica ``slot`` (``kind="kill_replica"``), the whole
    stage (``kind="kill_stage"``, slot ignored), or apply a *sustained
    slowdown* — multiply the stage's service time by ``factor`` from this
    point on (``kind="slowdown"``; the drift scenario the self-healing
    loop reacts to, delivered through the monkey's ``slowdown_target``
    hook since stage-fn timing lives in the harness, not the executor)."""

    at_s: float
    kind: str
    stage: int
    slot: int = 0
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in ("kill_replica", "kill_stage", "slowdown"):
            raise ValueError(f"unknown chaos kind: {self.kind!r}")
        if self.at_s < 0:
            raise ValueError(f"at_s must be >= 0, got {self.at_s}")
        if self.kind == "slowdown" and self.factor <= 0:
            raise ValueError(f"slowdown factor must be > 0, "
                             f"got {self.factor}")


def replica_kill_schedule(replicas: Sequence[int], n_kills: int,
                          duration_s: float, seed: int = 0,
                          spare_last: bool = True,
                          max_per_stage: Optional[int] = None
                          ) -> List[ChaosEvent]:
    """Seeded schedule of ``n_kills`` replica kills spread across the
    middle 80% of ``duration_s``.  Each (stage, slot) dies at most once.
    ``spare_last=True`` (the failover scenario) never kills slot 0, so
    every stage keeps at least one survivor; ``spare_last=False`` allows
    full stage loss (the degraded-replan scenario).  ``max_per_stage``
    caps kills per stage — a failover *latency* experiment should leave
    each stage enough survivors to carry the offered load, otherwise it
    measures overload, not failover.  Same seed, same arguments →
    identical schedule."""
    rnd = random.Random(seed)
    candidates = [(i, j) for i, k in enumerate(replicas)
                  for j in range(1 if spare_last else 0, k)]
    rnd.shuffle(candidates)
    picked = []
    per_stage: Dict[int, int] = {}
    for (i, j) in candidates:
        if len(picked) >= max(0, n_kills):
            break
        if max_per_stage is not None \
                and per_stage.get(i, 0) >= max_per_stage:
            continue
        per_stage[i] = per_stage.get(i, 0) + 1
        picked.append((i, j))
    lo, hi = 0.1 * duration_s, 0.9 * duration_s
    times = sorted(rnd.uniform(lo, hi) for _ in picked)
    return [ChaosEvent(at_s=t, kind="kill_replica", stage=i, slot=j)
            for t, (i, j) in zip(times, picked)]


class ChaosMonkey:
    """Execute a chaos schedule against a live executor.

    Takes a *getter* rather than the executor itself so the schedule
    keeps applying across ``reconfigure()`` hot-swaps (the server's
    ``.executor`` property changes identity).  Kills that no longer apply
    — executor stopped, stage index out of range after a replan — are
    recorded as skipped, not raised."""

    def __init__(self, executor_getter: Callable[[], PipelineExecutor],
                 events: Sequence[ChaosEvent],
                 slowdown_target: Optional[Callable[[int, float],
                                                    None]] = None):
        self.get = executor_getter
        self.events = sorted(events, key=lambda e: e.at_s)
        # ``slowdown`` events land here (stage, factor) — the harness owns
        # stage-fn timing, so it decides what "this stage got slower" means
        self.slowdown_target = slowdown_target
        self.applied: List[Tuple[ChaosEvent, bool]] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self) -> "ChaosMonkey":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="chaos-monkey")
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def _run(self) -> None:
        t0 = time.monotonic()
        for ev in self.events:
            delay = ev.at_s - (time.monotonic() - t0)
            if delay > 0 and self._stop.wait(delay):
                # harness asked us to stop before this event fired; record
                # the remainder as skipped so reports are complete
                self.applied.append((ev, False))
                continue
            ok = True
            try:
                if ev.kind == "slowdown":
                    if self.slowdown_target is None:
                        ok = False
                    else:
                        self.slowdown_target(ev.stage, ev.factor)
                else:
                    ex = self.get()
                    if ev.kind == "kill_stage":
                        ex.kill_stage(ev.stage)
                    else:
                        ex.kill_replica(ev.stage, ev.slot)
            except (RuntimeError, ValueError, IndexError):
                ok = False
            self.applied.append((ev, ok))


@dataclasses.dataclass
class ChaosReport:
    submitted: int
    completed: int
    failed: int
    lost: int
    misordered: int
    duration_s: float
    latency: Dict[str, float]
    health: Dict[str, Any]
    kills_applied: int

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _percentile(sorted_xs: List[float], q: float) -> float:
    if not sorted_xs:
        return 0.0
    idx = min(len(sorted_xs) - 1, int(round(q * (len(sorted_xs) - 1))))
    return sorted_xs[idx]


def run_chaos_executor(stage_fns: Sequence[Callable[[Any], Any]],
                       replicas: Sequence[int],
                       n_requests: int,
                       interval_s: float = 0.0,
                       events: Sequence[ChaosEvent] = (),
                       hedge_after: Optional[float] = None,
                       queue_size: int = 64,
                       timeout_s: float = 120.0) -> ChaosReport:
    """One open-loop chaos run against a raw :class:`PipelineExecutor`.

    Submits the integers ``0..n_requests-1`` at a fixed ``interval_s``
    while a :class:`ChaosMonkey` executes ``events``, then audits the
    exactly-once contract.  ``stage_fns`` must propagate their input's
    identity (return the input, possibly after work) so the appended tap
    stage can record exit order; items that fail (``StageLost`` when a
    whole stage dies) count as ``failed``, never ``lost``."""
    exit_order: List[int] = []
    tap_lock = threading.Lock()

    def tap(x):
        with tap_lock:
            exit_order.append(int(x))
        return x

    ex = PipelineExecutor(list(stage_fns) + [tap],
                          replicas=list(replicas) + [1],
                          queue_size=queue_size, hedge_after=hedge_after,
                          name="chaos")
    monkey = ChaosMonkey(lambda: ex, events)
    t_submit: List[float] = [0.0] * n_requests
    t_done: List[Optional[float]] = [None] * n_requests
    futures = []
    t0 = time.monotonic()

    def stamp(i):
        # done-callbacks fire on the collector thread the moment the
        # future resolves — latency must not include the time this
        # harness spends still submitting the rest of the open loop
        def cb(_f):
            t_done[i] = time.monotonic()
        return cb

    with ex:
        monkey.start()
        for i in range(n_requests):
            t_submit[i] = time.monotonic()
            fut = ex.submit(i)
            fut.add_done_callback(stamp(i))
            futures.append(fut)
            if interval_s > 0:
                time.sleep(interval_s)
        lat: List[float] = []
        completed = failed = lost = 0
        deadline = time.monotonic() + timeout_s
        for i, fut in enumerate(futures):
            try:
                val = fut.result(timeout=max(0.01,
                                             deadline - time.monotonic()))
                if val != i:
                    raise AssertionError(
                        f"identity broken: submitted {i}, got {val!r}")
                completed += 1
                lat.append((t_done[i] or time.monotonic()) - t_submit[i])
            except (_FutureTimeout, TimeoutError):
                lost += 1
            except Exception:
                failed += 1
        health = ex.health_snapshot()
        monkey.join(timeout=5)
    duration = time.monotonic() - t0
    lat.sort()
    # hedged duplicates are deduped by the merge, so each request exits
    # at most once; any adjacent inversion is a real ordering violation
    misordered = sum(1 for a, b in zip(exit_order, exit_order[1:])
                     if b < a)
    return ChaosReport(
        submitted=n_requests, completed=completed, failed=failed,
        lost=lost, misordered=misordered, duration_s=duration,
        latency={
            "p50_ms": 1e3 * _percentile(lat, 0.50),
            "p90_ms": 1e3 * _percentile(lat, 0.90),
            "p99_ms": 1e3 * _percentile(lat, 0.99),
            "mean_ms": 1e3 * (sum(lat) / len(lat)) if lat else 0.0,
            "max_ms": 1e3 * (lat[-1] if lat else 0.0),
        },
        health={"hedges": health["hedges"],
                "redispatches": health["redispatches"],
                "live_replicas": health["live_replicas"]},
        kills_applied=sum(1 for _, ok in monkey.applied if ok),
    )
