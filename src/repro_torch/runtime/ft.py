"""Fault-tolerant runtime: checkpoint/restart training, fault injection,
elastic replanning, and health-monitored degraded-mode serving.

* :class:`TrainSupervisor` — checkpoint/restart loop: periodic async
  checkpoints, automatic restore-and-replay on step failure (a failure
  surfaces as an exception on the host — of *any* type, so every
  ``Exception`` triggers a restart), bounded restart budget.  With an empty
  store the restart is a clean replay from ``start_step`` with the initial
  state.  Because the data pipeline is step-addressable, replay is exact.
  On CUDA, a device fault (an illegal address, a kernel that traps) is
  sticky: the process's CUDA context is dead, every later call on the
  card raises too, and no in-process restart recovers it — only a new
  process does.  The supervisor restarts on exceptions all the same, as
  the reference's does; against a sticky fault it spends its restart
  budget and raises.
* :class:`FailureInjector` — deterministic + seeded-random fault injection
  for tests/examples/chaos: fail at step k, fail with independent per-step
  probability p, restricted to a named target, raising a configurable
  exception type (``ReplicaFailure`` for the executor chaos hooks), and a
  callable-target mode (:meth:`FailureInjector.wrap`) that turns any stage
  function into a chaos-injected one.
* :class:`ElasticPlanner` — elastic scaling hook: when the healthy device
  count changes, re-derive the segmentation plan with the paper's
  O(d log sum P) balanced split.  The paper's §2.2 argument — *fast*
  partitioning enables dynamic edge deployments — is exactly what makes
  replan-on-resize viable here (ms-scale, vs profiling-based partitioners).
  :meth:`ElasticPlanner.resize_server` drives a live streaming
  ``PipelinedModelServer`` through a resize: replan, rebuild the stage
  functions, and hot-swap the server's executor (in-flight requests drain
  first; requests still queued are served by the new plan).
* :class:`HealthMonitor` + :class:`FaultPolicy` — the closed loop between
  the executor's failure domains and the planner: it watches
  ``PipelineExecutor.health_snapshot()`` (heartbeats, consecutive
  item-failure counts per stage/replica), withdraws replicas that exceed
  the policy (``kill_replica`` — the executor re-dispatches their
  in-flight work), and on losing the *last* replica of a stage replans
  against the shrunken device pool and hot-swaps through the existing
  ``reconfigure()`` drain path, optionally warm-restoring stage state
  from a ``checkpoint.CheckpointStore`` first.
"""
from __future__ import annotations

import dataclasses
import queue
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..api import DeploymentSpec
from ..api import plan as plan_spec
from ..checkpoint import CheckpointStore
from ..core.graph import LayerGraph
from ..core.placement import PlacementPlan


class FailureInjector:
    """Deterministic + seeded-random fault injection.

    * ``fail_at_steps`` — raise at exactly these steps, once per
      (target, step).
    * ``fail_rate`` — seeded per-step coin.  The decision is *independent*
      per (target, step) and independent of the deterministic schedule
      (separate fired sets), so a deterministic failure at a step never
      suppresses — or forces — a random one at the same step.
    * ``fail_target`` — restrict firing to one named target (a stage name,
      a replica id), so one injector can be shared across many call sites.
    * ``exc_type`` — the exception class raised; pass
      :class:`repro_torch.core.pipeline.ReplicaFailure` to make the executor
      treat the fault as a replica death (failover) rather than an item
      failure.
    * :meth:`wrap` — callable-target mode: wrap a stage function with a
      per-target call counter driving :meth:`check`, the hook the chaos
      harness uses to kill workers from inside the pipeline.
    """

    def __init__(self, fail_at_steps=(), fail_rate: float = 0.0,
                 seed: int = 0, exc_type: type = RuntimeError,
                 fail_target: Optional[str] = None):
        self.fail_at = set(fail_at_steps)
        self.fail_rate = fail_rate
        self.exc_type = exc_type
        self.fail_target = fail_target
        self._seed = seed
        self._fired_at = set()      # (target, step) deterministic firings
        self._decided_rate = set()  # (target, step) coins already flipped
        self._counts: Dict[Optional[str], int] = {}
        self._lock = threading.Lock()

    def check(self, step: int, target: Optional[str] = None) -> None:
        if self.fail_target is not None and target != self.fail_target:
            return
        key = (target, step)
        if step in self.fail_at and key not in self._fired_at:
            self._fired_at.add(key)
            where = f" on {target}" if target else ""
            raise self.exc_type(f"injected failure at step {step}{where}")
        if self.fail_rate > 0.0 and key not in self._decided_rate:
            # flip the coin exactly once per (target, step); independent
            # of whether the deterministic schedule fired there
            self._decided_rate.add(key)
            rnd = random.Random(f"{self._seed}:{target}:{step}")
            if rnd.random() < self.fail_rate:
                where = f" on {target}" if target else ""
                raise self.exc_type(
                    f"injected random failure at step {step}{where}")

    def wrap(self, fn: Callable[[Any], Any],
             target: str) -> Callable[[Any], Any]:
        """Callable-target mode: a stage function whose calls are counted
        per ``target`` and checked against this injector — usable directly
        as a ``PipelineExecutor`` stage fn (the executor chaos hook)."""
        def wrapped(x):
            with self._lock:
                step = self._counts.get(target, 0)
                self._counts[target] = step + 1
            self.check(step, target=target)
            return fn(x)
        wrapped.__name__ = f"chaos[{target}]"
        return wrapped


@dataclasses.dataclass
class SupervisorReport:
    final_step: int
    restarts: int
    checkpoints: int
    history: list


class TrainSupervisor:
    """Run `n_steps` of `step_fn` with checkpoint/restart fault tolerance.

    step_fn(state, step) -> (state, metrics).  `state` must be a pytree
    (params + opt state + anything needed to resume).
    """

    def __init__(self, store: CheckpointStore, step_fn: Callable,
                 ckpt_every: int = 50, max_restarts: int = 8,
                 injector: Optional[FailureInjector] = None,
                 async_ckpt: bool = True):
        self.store = store
        self.step_fn = step_fn
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.injector = injector
        self.async_ckpt = async_ckpt

    def run(self, state: Any, n_steps: int, start_step: int = 0
            ) -> tuple:
        restarts = 0
        checkpoints = 0
        history = []
        initial_state = state     # clean-restart fallback (store empty)
        # resume from latest checkpoint if one exists
        latest = self.store.latest_step()
        if latest is not None and latest > start_step:
            latest, state = self.store.restore(state)
            start_step = latest
        step = start_step
        while step < n_steps:
            try:
                if self.injector is not None:
                    self.injector.check(step)
                state, metrics = self.step_fn(state, step)
                history.append((step, metrics))
                step += 1
                if step % self.ckpt_every == 0 or step == n_steps:
                    self.store.save(step, state,
                                    blocking=not self.async_ckpt)
                    checkpoints += 1
            # a failure surfaces as whatever the backend raises (not
            # always RuntimeError) — any Exception restarts
            except Exception as e:
                restarts += 1
                if restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded restart budget ({self.max_restarts}): {e}")
                restored = None
                if self.store.has_checkpoint():
                    restored, restored_state = self.store.restore(state)
                if restored is None:
                    # empty (or fully corrupt) store: restart cleanly from
                    # the initial state, not from the failed mid-run state
                    state = initial_state
                    step = start_step
                else:
                    state = restored_state
                    step = restored
        self.store.wait()
        return state, SupervisorReport(final_step=step, restarts=restarts,
                                       checkpoints=checkpoints,
                                       history=history)


class ElasticPlanner:
    """Re-plan the pipeline segmentation when the device pool resizes.

    Planning goes through the ``repro_torch.api`` front door: the planner holds
    one base :class:`~repro_torch.api.DeploymentSpec` (built from the legacy
    ``strategy`` name, or passed in whole via ``spec=``) and re-derives it
    at each device count with ``spec.with_stages(n)``."""

    def __init__(self, graph: LayerGraph, strategy: str = "balanced",
                 spec: Optional[DeploymentSpec] = None):
        self.graph = graph
        self.spec = spec if spec is not None \
            else DeploymentSpec(strategy=strategy)
        self.strategy = self.spec.strategy
        self._cache: Dict[int, PlacementPlan] = {}
        self.replan_times: Dict[int, float] = {}

    def plan_for(self, n_devices: int) -> PlacementPlan:
        if n_devices not in self._cache:
            t0 = time.perf_counter()
            # attach_report=False: replan_times is a reported latency
            # metric and must keep measuring the plan search alone
            self._cache[n_devices] = plan_spec(
                self.spec.with_stages(n_devices), graph=self.graph,
                attach_report=False)
            self.replan_times[n_devices] = time.perf_counter() - t0
        return self._cache[n_devices]

    def on_resize(self, healthy_devices: int) -> PlacementPlan:
        """Called by the serving loop when devices join/leave."""
        return self.plan_for(max(1, healthy_devices))

    def resize_server(self, server: Any,
                      stage_fn_builder: Callable[[PlacementPlan],
                                                 List[Callable]],
                      healthy_devices: int,
                      drain_timeout: float = 30.0) -> PlacementPlan:
        """Elastic hook for a live streaming server: replan for the
        surviving devices, build the new per-stage functions, and hot-swap
        the server's executor via ``server.reconfigure`` (admission pauses,
        in-flight requests drain, queued requests are served by the new
        plan).  Returns the new plan."""
        pl = self.on_resize(healthy_devices)
        server.reconfigure(pl, stage_fn_builder(pl),
                           drain_timeout=drain_timeout)
        return pl


@dataclasses.dataclass
class FaultPolicy:
    """When the health monitor declares a replica dead and how fast it
    reacts.

    * ``heartbeat_timeout_s`` — a replica whose heartbeat is older than
      this *while the executor has work in flight* is withdrawn (a hung
      device: its in-flight envelopes are re-dispatched, and any result
      the zombie later produces is deduplicated by the merge).  ``None``
      disables heartbeat-based kills.
    * ``max_consecutive_failures`` — a replica whose stage function failed
      this many items in a row is withdrawn (a sick device: persistent
      item errors are a death signal, per-item errors stay per-item below
      the threshold).  ``None`` disables.
    * ``poll_interval_s`` — monitor loop cadence; also bounds how quickly
      a stage-lost event turns into a degraded-mode replan.
    * ``min_devices`` — never replan below this many devices.
    """

    heartbeat_timeout_s: Optional[float] = None
    max_consecutive_failures: Optional[int] = None
    poll_interval_s: float = 0.02
    min_devices: int = 1


class HealthMonitor:
    """Close the loop: executor failure domains -> degraded-mode replan.

    Wires itself to the server's stage-lost notifications (re-wired
    automatically across ``reconfigure`` swaps) and polls
    ``health_snapshot()`` under a :class:`FaultPolicy`.  On losing the
    last replica of a stage it counts the surviving replicas across the
    old executor, optionally warm-restores state via ``warm_restore()``
    (e.g. re-read stage params from a ``CheckpointStore`` so replacement
    devices start from the latest snapshot), and drives
    ``ElasticPlanner.resize_server`` — replan for the shrunken pool, hot
    swap through the drain path.  Requests that failed fast as
    ``StageLost`` meanwhile are re-admitted by the server's
    ``stage_loss_retries`` policy and served by the new plan: zero lost
    requests end to end.

    The replan runs on the monitor's own thread — never on an executor
    worker — because ``reconfigure`` joins the executor's threads.
    """

    def __init__(self, server: Any, planner: ElasticPlanner,
                 stage_fn_builder: Callable[[PlacementPlan],
                                            List[Callable]],
                 policy: Optional[FaultPolicy] = None,
                 warm_restore: Optional[Callable[[], None]] = None):
        self.server = server
        self.planner = planner
        self.stage_fn_builder = stage_fn_builder
        self.policy = policy if policy is not None else FaultPolicy()
        self.warm_restore = warm_restore
        self.replans: List[Dict[str, Any]] = []
        self.kills: List[tuple] = []
        self._events: "queue.Queue[int]" = queue.Queue()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        server.add_stage_lost_listener(self.notify_stage_lost)

    # executor threads call this: enqueue only, never block
    def notify_stage_lost(self, stage: int) -> None:
        self._events.put(stage)

    def start(self) -> "HealthMonitor":
        if self._thread is not None:
            return self
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"health-{getattr(self.server.plan, 'graph_name', '?')}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "HealthMonitor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- monitor loop --------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                stage = self._events.get(timeout=self.policy.poll_interval_s)
            except queue.Empty:
                self._probe()
                continue
            self._replan(stage)

    def _probe(self) -> None:
        """Policy-driven replica withdrawal: stale heartbeats while work
        is in flight, or too many consecutive item failures."""
        pol = self.policy
        if pol.heartbeat_timeout_s is None \
                and pol.max_consecutive_failures is None:
            return
        ex = self.server.executor
        if not ex.started:
            return
        h = ex.health_snapshot()
        busy = ex.in_flight > 0
        for i, alive_row in enumerate(h["alive"]):
            for j, alive in enumerate(alive_row):
                if not alive:
                    continue
                stale = (pol.heartbeat_timeout_s is not None and busy
                         and h["heartbeat_age_s"][i][j]
                         > pol.heartbeat_timeout_s)
                sick = (pol.max_consecutive_failures is not None
                        and h["consecutive_failures"][i][j]
                        >= pol.max_consecutive_failures)
                if not (stale or sick):
                    continue
                try:
                    ex.kill_replica(i, j)
                    self.kills.append((i, j, "stale" if stale else "sick"))
                except (RuntimeError, ValueError):
                    pass        # executor swapped/stopped under the probe

    def _replan(self, stage: int) -> None:
        """Degraded mode: replan against the surviving devices and hot
        swap.  Coalesces queued stage-lost events — one replan covers
        every stage lost in the same epoch."""
        lost = {stage}
        while True:
            try:
                lost.add(self._events.get_nowait())
            except queue.Empty:
                break
        ex = self.server.executor
        h = ex.health_snapshot()
        healthy = max(self.policy.min_devices,
                      sum(h["live_replicas"]))
        if self.warm_restore is not None:
            try:
                self.warm_restore()
            except Exception:
                pass            # cold rebuild beats no rebuild
        t0 = time.perf_counter()
        pl = self.planner.resize_server(self.server, self.stage_fn_builder,
                                        healthy)
        self.replans.append({
            "lost_stages": sorted(lost),
            "healthy_devices": healthy,
            "n_stages": pl.n_stages,
            "replan_s": time.perf_counter() - t0,
        })
