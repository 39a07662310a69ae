"""Self-healing control plane: live drift detection, guarded replanning.

The paper's whole premise is that *profiled* costs beat analytic ones
(the off-chip cliff mispredictions of Seshadri et al.).  The profiling
package makes that an offline workflow (profile -> calibrate ->
``trace:<path>`` -> plan); this module closes the loop at runtime:

    telemetry ──> rolling trace ──> refit ──> drift? ──> replan
        ^  (snapshot deltas)  (LiveTraceBuilder)   |  (front-door registry,
        |                                          v   live cost_source)
    commit <── canary validate <── candidate executor
        |      (held-aside requests, observed bottleneck
        v       vs incumbent; fail/worse => ROLLBACK)
    serving on the trace-backed plan

Pieces:

* :class:`DriftPolicy` — every knob of the loop, a frozen dataclass.
* :class:`DriftDetector` — modeled-vs-observed per-stage drift.  The
  metric is **shape-based** (both vectors normalized by their means
  before comparing): a uniformly miscalibrated device — every stage 3x
  the model — still yields the *same* balanced cuts, so uniform scale
  error must not thrash replans; what triggers is relative imbalance the
  model did not predict, which is exactly when different cuts win.
  Observed times are EWMA-smoothed; the trigger needs ``hysteresis``
  *consecutive* over-threshold windows (a transient straggler is not
  drift) and is suppressed for ``cooldown_windows`` after every
  reconfigure (measured in windows, not seconds: deterministic under
  test clocks).
* :class:`SelfHealingController` — the loop itself.  Runs on its own
  thread (a replan must never run on an executor worker: ``reconfigure``
  joins those threads); every window it folds ``server.snapshot()``
  deltas into a :class:`~repro_torch.profiling.live.LiveTraceBuilder`, feeds
  the detector and, on a trigger, replans through ``repro_torch.api.plan`` with
  the live calibrated source and applies the result through a **guarded
  reconfigure**: build the candidate executor, validate it on held-aside
  canary payloads, commit only if its observed bottleneck stage time
  beats the incumbent's (x ``canary_margin``) — otherwise roll back
  (the incumbent never stopped serving; the prior plan + stage fns are
  kept warm in :attr:`SelfHealingController.prior` after a commit too).
  Canary failures retry under seeded-jitter exponential backoff
  (in windows); past ``max_canary_retries`` the loop **degrades** to the
  incumbent — it keeps observing, and re-arms once drift subsides.

Tests drive the loop deterministically through :meth:`tick` (one window,
synchronous); the thread is a convenience wrapper that calls it.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core.pipeline import PipelineExecutor
from ..core.placement import PlacementPlan
from ..profiling.live import LiveTraceBuilder

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class DriftPolicy:
    """Every knob of the self-healing loop.

    ``drift_threshold`` — relative per-stage shape deviation past which a
    window counts toward a trigger.  ``hysteresis`` — consecutive
    over-threshold windows required to trigger.  ``cooldown_windows`` —
    windows after any reconfigure/decision during which triggers are
    suppressed (the new plan needs fresh telemetry).  ``canary_margin`` —
    a candidate commits only if its canary bottleneck is <= incumbent's
    observed bottleneck times this factor (>1 tolerates canary noise).
    ``backoff_*_windows`` — seeded-jitter exponential backoff between
    canary retries; past ``max_canary_retries`` the loop degrades until
    drift subsides."""

    drift_threshold: float = 0.5
    hysteresis: int = 3
    cooldown_windows: int = 3
    min_window_requests: int = 1
    ewma_alpha: float = 0.5
    live_alpha: float = 0.25
    # which live source replans price against: "auto" uses the raw trace
    # when every depth has live coverage (a localized slowdown is exactly
    # measurable, and a global coefficient fit cannot express it) and the
    # calibrated fit when coverage is partial (it extrapolates
    # structurally to unvisited depths); "trace"/"calibrated" force one
    live_source: str = "auto"
    # strategy used for live replans on plain (non-placement) specs.  The
    # paper's SEGM_BALANCED cuts on raw per-depth *params* — live costs
    # would never move its cuts — so replans default to the time-balanced
    # minimax DP ("opt", never worse than balanced on modeled time).
    # "" keeps the spec's own strategy verbatim.
    replan_strategy: str = "opt"
    canary_requests: int = 4
    canary_margin: float = 1.10
    max_canary_retries: int = 3
    backoff_base_windows: int = 2
    backoff_max_windows: int = 16
    backoff_seed: int = 0

    def __post_init__(self):
        if self.drift_threshold < 0:
            raise ValueError("drift_threshold must be >= 0")
        if self.hysteresis < 1:
            raise ValueError("hysteresis must be >= 1")
        if self.cooldown_windows < 0:
            raise ValueError("cooldown_windows must be >= 0")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if self.canary_requests < 1:
            raise ValueError("canary_requests must be >= 1")
        if self.canary_margin <= 0:
            raise ValueError("canary_margin must be > 0")
        if self.max_canary_retries < 0:
            raise ValueError("max_canary_retries must be >= 0")
        if (self.backoff_base_windows < 1
                or self.backoff_max_windows < self.backoff_base_windows):
            raise ValueError("need 1 <= backoff_base_windows "
                             "<= backoff_max_windows")
        if self.live_source not in ("auto", "trace", "calibrated"):
            raise ValueError(f"live_source must be 'auto', 'trace' or "
                             f"'calibrated', got {self.live_source!r}")


class DriftDetector:
    """Modeled-vs-observed per-stage drift with EWMA + hysteresis.

    Deterministic: the same sequence of ``observe`` calls always yields
    the same drift values and trigger decisions (no clocks, no rng).
    """

    def __init__(self, policy: DriftPolicy):
        self.policy = policy
        self._ewma: Optional[List[float]] = None
        self._consec = 0
        self.last_drift = 0.0

    def rebase(self) -> None:
        """Forget the observed EWMA + trigger streak — call after every
        plan change (stage shapes moved; old telemetry is meaningless)."""
        self._ewma = None
        self._consec = 0
        self.last_drift = 0.0

    @staticmethod
    def _normalize(xs: Sequence[float]) -> Optional[List[float]]:
        mean = sum(xs) / len(xs)
        if mean <= _EPS:
            return None
        return [x / mean for x in xs]

    def observe(self, modeled: Sequence[float],
                observed: Sequence[float]) -> float:
        """Fold one window in; returns the (smoothed) drift metric.
        ``modeled`` is the live plan's per-stage modeled time,
        ``observed`` the window's per-item observed stage time
        (``snapshot()['stage_time_per_req_s']``)."""
        if len(modeled) != len(observed) or not modeled:
            self.rebase()
            return 0.0
        if self._ewma is None or len(self._ewma) != len(observed):
            self._ewma = list(observed)
        else:
            a = self.policy.ewma_alpha
            self._ewma = [a * o + (1 - a) * e
                          for o, e in zip(observed, self._ewma)]
        mod_n = self._normalize(modeled)
        obs_n = self._normalize(self._ewma)
        if mod_n is None or obs_n is None:
            return self.last_drift
        drift = max(abs(o - m) / max(m, _EPS)
                    for o, m in zip(obs_n, mod_n))
        self.last_drift = drift
        if drift > self.policy.drift_threshold:
            self._consec += 1
        else:
            self._consec = 0
        return drift

    @property
    def triggered(self) -> bool:
        return self._consec >= self.policy.hysteresis


class SelfHealingController:
    """The closed loop over a live :class:`PipelinedModelServer`.

    ``spec`` shapes every replan (the incumbent's stage/budget shape is
    kept — self-healing re-*cuts*, it does not re-*size*; that is
    ``runtime.ft.ElasticPlanner``'s job).  ``stage_fn_builder`` rebuilds
    stage callables for a candidate plan.  ``canary_payloads`` are the
    held-aside validation requests — they ride the *candidate* executor
    only, never the serving stream.

    States: ``steady`` (observing) -> ``cooldown`` (just decided;
    suppressing) -> ``backoff`` (canary failed; waiting) -> ``degraded``
    (retries exhausted; serving the incumbent, re-arms when drift
    subsides).  Inspect :attr:`events` / :attr:`state` for the history.
    """

    def __init__(self, server, spec, graph,
                 stage_fn_builder: Callable[[PlacementPlan],
                                            List[Callable[[Any], Any]]],
                 policy: Optional[DriftPolicy] = None,
                 canary_payloads: Sequence[Any] = (),
                 poll_interval_s: float = 0.25,
                 tpu_model=None, base_spec=None,
                 trace_builder: Optional[LiveTraceBuilder] = None):
        if graph is None:
            raise ValueError("SelfHealingController needs the live "
                             "LayerGraph (replans re-price it)")
        self.server = server
        self.spec = spec
        self.graph = graph
        self.builder = stage_fn_builder
        self.policy = policy or DriftPolicy()
        self.canary_payloads = list(canary_payloads)
        self.poll_interval_s = poll_interval_s
        self._tpu_model = tpu_model
        self._base_spec = base_spec
        self.trace = (trace_builder if trace_builder is not None
                      else LiveTraceBuilder(graph,
                                            alpha=self.policy.live_alpha))
        self.detector = DriftDetector(self.policy)
        self.state = "steady"
        self.prior: Optional[Tuple[PlacementPlan, List[Callable]]] = None
        self.events: List[Dict[str, Any]] = []
        self.windows = 0
        self.replans = 0
        self.commits = 0
        self.rollbacks = 0
        self._cooldown = 0
        self._backoff = 0
        self._retries = 0
        self._rng = random.Random(self.policy.backoff_seed)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "SelfHealingController":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.poll_interval_s):
                try:
                    self.tick()
                except Exception as e:      # the loop must outlive a bad
                    self._event("error", error=repr(e))   # window
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="selfheal")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def __enter__(self) -> "SelfHealingController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the loop ------------------------------------------------------------
    def _event(self, kind: str, **fields) -> None:
        self.events.append({"window": self.windows, "kind": kind,
                            "state": self.state, **fields})

    def _modeled_stage_times(self, plan: PlacementPlan
                             ) -> Optional[List[float]]:
        ts = plan.stage_times_s
        if any(t is None for t in ts):
            return None
        return [float(t) for t in ts]

    def tick(self) -> Optional[float]:
        """One control window: snapshot -> refit -> detect -> (maybe)
        guarded replan.  Returns the window's drift metric, or None when
        the window carried no telemetry signal.  Synchronous and
        deterministic given the snapshot stream — tests drive this
        directly."""
        snap = self.server.snapshot()
        plan = self.server.plan
        ranges = [tuple(r) for r in plan.stage_depth_ranges]
        per_item = snap.get("stage_time_per_req_s")
        items = snap.get("stage_items")
        if per_item is None or items is None:
            return None
        self.windows += 1
        if sum(items) < self.policy.min_window_requests * len(items):
            return None
        self.trace.observe(ranges, per_item, items)
        modeled = self._modeled_stage_times(plan)
        if modeled is None:
            return None
        drift = self.detector.observe(modeled, per_item)
        if self.state == "degraded":
            # serving the incumbent; re-arm only once drift subsides (a
            # calm window means the world stopped shifting under us)
            if drift <= self.policy.drift_threshold:
                self._retries = 0
                self.state = "steady"
                self._event("rearmed", drift=drift)
            return drift
        if self._backoff > 0:
            self._backoff -= 1
            return drift
        if self._cooldown > 0:
            self._cooldown -= 1
            return drift
        if self.state == "cooldown":
            self.state = "steady"
        if self.detector.triggered:
            self._attempt_replan(drift)
        return drift

    # -- guarded reconfigure -------------------------------------------------
    def _attempt_replan(self, drift: float) -> None:
        from ..api.deploy import plan as plan_fn
        self.replans += 1
        kind = self.policy.live_source
        if kind == "auto":
            kind = ("trace" if self.trace.coverage() >= 0.999
                    else "calibrated")
        live_src = self.trace.cost_source(kind)
        incumbent = self.server.plan
        shaped = self.spec.with_stages(incumbent.n_devices)
        strat = self.policy.replan_strategy
        if (strat and shaped.resolved_topology() is None
                and shaped.strategy != strat):
            # params-balancing strategies are blind to live costs; replan
            # through a time-balancing one (objective cleared: it was
            # declared against the original strategy)
            shaped = dataclasses.replace(shaped, strategy=strat,
                                         objective=None)
        try:
            candidate = plan_fn(shaped, graph=self.graph,
                                tpu_model=self._tpu_model,
                                base_spec=self._base_spec,
                                cost_source=live_src,
                                attach_report=False)
        except Exception as e:
            self._event("replan_failed", drift=drift, error=repr(e))
            self._canary_failed(drift)
            return
        if (candidate.cuts == incumbent.cuts
                and candidate.replica_counts == incumbent.replica_counts):
            # the live-trace-priced planner endorses the incumbent: the
            # drift is real but no better cuts exist — stand down
            self._event("noop", drift=drift,
                        coverage=self.trace.coverage())
            self.detector.rebase()
            self.state = "cooldown"
            self._cooldown = self.policy.cooldown_windows
            return
        ok, observed_bottleneck, canary_bottleneck, err = (
            self._canary_validate(candidate))
        if ok:
            self._commit(candidate, drift, observed_bottleneck,
                         canary_bottleneck)
        else:
            self._event("rollback", drift=drift, error=err,
                        incumbent_bottleneck_s=observed_bottleneck,
                        canary_bottleneck_s=canary_bottleneck,
                        retries=self._retries + 1)
            self.rollbacks += 1
            self._canary_failed(drift)

    def _canary_validate(self, candidate: PlacementPlan
                         ) -> Tuple[bool, float, Optional[float],
                                    Optional[str]]:
        """Run the held-aside canaries through a freshly-built candidate
        executor (the incumbent keeps serving — it is the warm rollback
        target by construction).  Pass iff the candidate's observed
        bottleneck per-item stage time beats the incumbent's observed
        bottleneck x ``canary_margin``."""
        observed = self.detector._ewma or []
        incumbent_bottleneck = max(observed) if observed else float("inf")
        payloads = (self.canary_payloads
                    [:max(1, self.policy.canary_requests)])
        if not payloads:
            return False, incumbent_bottleneck, None, "no canary payloads"
        try:
            fns = self.builder(candidate)
            ex = PipelineExecutor.for_plan(candidate, fns,
                                           name_prefix="canary")
            with ex:
                _, busy = ex.run_batch(payloads,
                                       collect_stage_times=True)
        except Exception as e:
            return False, incumbent_bottleneck, None, repr(e)
        per_item = [b / len(payloads) for b in busy]
        canary_bottleneck = max(per_item) if per_item else float("inf")
        ok = (canary_bottleneck
              <= incumbent_bottleneck * self.policy.canary_margin)
        return ok, incumbent_bottleneck, canary_bottleneck, None

    def _commit(self, candidate: PlacementPlan, drift: float,
                incumbent_bottleneck: float,
                canary_bottleneck: Optional[float]) -> None:
        # the prior plan + stage fns stay warm: a caller (or a future
        # regression guard) can swap back without replanning
        self.prior = (self.server.plan, list(self.server.stage_fns))
        fns = self.builder(candidate)
        self.server.reconfigure(candidate, fns)
        self.commits += 1
        self._retries = 0
        self.detector.rebase()
        self.state = "cooldown"
        self._cooldown = self.policy.cooldown_windows
        self._event("commit", drift=drift,
                    cuts=list(candidate.cuts),
                    replicas=list(candidate.replica_counts),
                    incumbent_bottleneck_s=incumbent_bottleneck,
                    canary_bottleneck_s=canary_bottleneck,
                    coverage=self.trace.coverage())

    def _canary_failed(self, drift: float) -> None:
        self._retries += 1
        if self._retries > self.policy.max_canary_retries:
            self.state = "degraded"
            self._event("degraded", drift=drift, retries=self._retries)
            return
        base = min(self.policy.backoff_max_windows,
                   self.policy.backoff_base_windows
                   * (2 ** (self._retries - 1)))
        # seeded jitter (0..1 extra windows): deterministic, but spreads
        # concurrent controllers that share a seed-free default
        self._backoff = base + self._rng.randrange(0, 2)
        self.state = "backoff"
        self.detector.rebase()

    def rollback_last(self) -> bool:
        """Swap back to the pre-commit plan + stage fns kept warm by the
        last commit (manual escape hatch).  Returns False when there is
        nothing to roll back to."""
        if self.prior is None:
            return False
        plan, fns = self.prior
        self.server.reconfigure(plan, fns)
        self.prior = None
        self.rollbacks += 1
        self.detector.rebase()
        self.state = "cooldown"
        self._cooldown = self.policy.cooldown_windows
        self._event("manual_rollback", cuts=list(plan.cuts))
        return True
