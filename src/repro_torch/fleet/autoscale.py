"""SLO-headroom autoscaler: move devices between fleet members, guarded.

The pool split (:mod:`repro_torch.fleet.placement`) is solved against the
*modeled* cost of each member; live traffic drifts away from any model —
a member's arrival mix shifts and its p95 blows through the target while
a neighbor idles on devices it no longer needs.  The autoscaler closes
that loop the same way the self-healing controller closes the
single-model one (:mod:`repro_torch.runtime.selfheal`): a synchronous,
deterministic :meth:`FleetAutoscaler.tick` that folds each member's
``snapshot()`` deltas into an observed SLO attainment ratio, plus a
thread wrapper for production use.

One tick = at most one device move:

1. **Observe** — per member, fold the snapshot window into an EWMA of
   the observed norm (p95 / target, and required-rate / observed-rate
   when the member shows pressure: sheds, deadline misses, or standing
   queue).  Thin windows (too few completions) leave the EWMA untouched.
2. **Select** — the worst member with norm past the violation threshold
   is the receiver; the donor is the member whose *modeled* norm after
   giving up a device stays under ``1 / donor_headroom`` (modeled via
   the same per-member replan the pool split used; observed norm breaks
   ties).  Donors never drop below ``max(1, min_devices)``; receivers
   never exceed ``max_devices``.
3. **Move** — donor resizes to k-1, receiver to k+1, both through the
   existing ``Deployment.reconfigure`` -> server hot-swap drain path
   (in-flight requests drain, queued requests land on the new plan —
   nothing is lost or reordered).
4. **Guard** — for ``guard_ticks`` windows the move is provisional; then
   the receiver must have improved (or reached attainment) and the donor
   must not have become the new worst violator, else the move is rolled
   back (the reverse resize).  Commit or rollback, a cooldown of
   ``cooldown_ticks`` quiet windows follows.  Every decision lands in
   :attr:`FleetAutoscaler.events`.

Device moves need a resizable member shape, so the autoscaler requires
the partitioned mode on a homogeneous pool (``device_budget`` resizes;
a pinned heterogeneous sub-chain does not) — ``deploy_fleet`` simply
skips the autoscaler otherwise.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

from ..api.deploy import Deployment, plan as plan_one
from .placement import slo_norm
from .spec import FleetSpec

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """When the autoscaler acts and how suspicious it stays.

    * ``violation_threshold`` — observed norm past this marks a member
      as violating (1.0 = exactly at SLO).
    * ``donor_headroom`` — a donor's *modeled* norm after giving up a
      device must stay under ``1 / donor_headroom``; > 1 keeps donors
      comfortably inside SLO rather than trading one violation for
      another.
    * ``guard_ticks`` — windows a move stays provisional before the
      commit-or-rollback verdict.
    * ``cooldown_ticks`` — quiet windows after a verdict (telemetry from
      mid-swap windows would feed the next decision noise).
    * ``min_window_requests`` — windows with fewer completions leave the
      observed-norm EWMA untouched (no signal, no update).
    * ``ewma_alpha`` — weight of the newest window in the observed norm.
    * ``min_improvement`` — relative receiver improvement the guard
      accepts as progress when the receiver is still past threshold.
    """

    violation_threshold: float = 1.0
    donor_headroom: float = 1.2
    guard_ticks: int = 2
    cooldown_ticks: int = 1
    min_window_requests: int = 5
    ewma_alpha: float = 0.5
    min_improvement: float = 0.05

    def __post_init__(self):
        if self.violation_threshold <= 0:
            raise ValueError("violation_threshold must be > 0")
        if self.donor_headroom <= 0:
            raise ValueError("donor_headroom must be > 0")
        if self.guard_ticks < 1:
            raise ValueError("guard_ticks must be >= 1")
        if self.cooldown_ticks < 0:
            raise ValueError("cooldown_ticks must be >= 0")
        if not 0 < self.ewma_alpha <= 1:
            raise ValueError("ewma_alpha must be in (0, 1]")


class FleetAutoscaler:
    """Drive device moves between the fleet's member deployments.

    ``deployments`` maps member name -> live :class:`Deployment` (the
    reconfigure target *and* the ``snapshot()`` source via its server);
    ``device_counts`` the solved pool split the fleet launched with.
    :meth:`tick` is synchronous and deterministic — benchmarks and tests
    drive it directly; :meth:`start` wraps it in a paced thread.
    """

    def __init__(self, fleet: FleetSpec,
                 deployments: Dict[str, Deployment],
                 device_counts: Dict[str, int],
                 policy: Optional[AutoscalePolicy] = None):
        if set(deployments) != set(fleet.member_names):
            raise ValueError("deployments must cover exactly the fleet's "
                             "members")
        if set(device_counts) != set(fleet.member_names):
            raise ValueError("device_counts must cover exactly the "
                             "fleet's members")
        self.fleet = fleet
        self.policy = policy if policy is not None else AutoscalePolicy(
            cooldown_ticks=fleet.rebalance_cooldown_windows,
            donor_headroom=fleet.rebalance_headroom)
        self._deps = dict(deployments)
        self.device_counts = dict(device_counts)
        self._norm_ewma: Dict[str, Optional[float]] = {
            n: None for n in self._deps}
        self._modeled_cache: Dict[tuple, float] = {}
        self._pending: Optional[Dict[str, Any]] = None
        self._cooldown = 0
        self._tick_no = 0
        self._lock = threading.Lock()
        self.events: List[Dict[str, Any]] = []
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- observation ---------------------------------------------------------
    def _observed_norm(self, name: str, snap: Dict[str, Any]
                       ) -> Optional[float]:
        """Fold one snapshot window into the member's observed SLO norm,
        or None when the window carries no usable signal."""
        spec = self.fleet.member(name).spec
        terms: List[float] = []
        lat = snap.get("latency", {})
        if (spec.slo_p95_ms is not None
                and lat.get("n", 0) >= self.policy.min_window_requests):
            terms.append(lat["p95_s"] / (spec.slo_p95_ms / 1e3))
        pressure = (snap.get("shed", 0) + snap.get("deadline_exceeded", 0)
                    + snap.get("queue_depth", 0)) > 0
        if spec.slo_throughput_rps is not None and pressure:
            rate = max(snap.get("throughput_rps", 0.0), _EPS)
            terms.append(spec.slo_throughput_rps / rate)
        return max(terms) if terms else None

    def _fold(self, name: str, snap: Dict[str, Any]) -> None:
        obs = self._observed_norm(name, snap)
        if obs is None:
            return
        prev = self._norm_ewma[name]
        a = self.policy.ewma_alpha
        self._norm_ewma[name] = obs if prev is None \
            else a * obs + (1 - a) * prev

    def _modeled_norm(self, name: str, k: int) -> float:
        """The pool-split cost oracle at a hypothetical device count:
        replan the member at k devices, normalize the modeled bottleneck
        against its SLO."""
        key = (name, k)
        if key not in self._modeled_cache:
            dep = self._deps[name]
            pl = plan_one(dep.spec.with_stages(k), graph=dep.graph,
                          attach_report=False)
            b = pl.max_stage_time_s
            self._modeled_cache[key] = (float("inf") if b is None
                                        else slo_norm(self.fleet.member(name),
                                                      b))
        return self._modeled_cache[key]

    # -- the control step ----------------------------------------------------
    def tick(self) -> Dict[str, Any]:
        """One deterministic control step: observe every member, then
        either advance a pending guard, sit out a cooldown, or attempt
        one device move.  Returns a record of what happened."""
        with self._lock:
            return self._tick_locked()

    def _tick_locked(self) -> Dict[str, Any]:
        self._tick_no += 1
        for name, dep in self._deps.items():
            srv = dep.server
            if srv is not None:
                self._fold(name, srv.snapshot())
        norms = {n: v for n, v in self._norm_ewma.items() if v is not None}

        if self._pending is not None:
            return self._advance_guard(norms)
        if self._cooldown > 0:
            self._cooldown -= 1
            return self._note("cooldown", norms=dict(norms),
                              remaining=self._cooldown)

        move = self._pick_move(norms)
        if move is None:
            return self._note("steady", norms=dict(norms))
        return self._execute(move, norms)

    def _pick_move(self, norms: Dict[str, float]
                   ) -> Optional[Dict[str, Any]]:
        pol = self.policy
        violating = sorted(
            (n for n, v in norms.items() if v > pol.violation_threshold),
            key=lambda n: -norms[n])
        for recv in violating:
            m_recv = self.fleet.member(recv)
            k_recv = self.device_counts[recv]
            if (m_recv.max_devices is not None
                    and k_recv + 1 > m_recv.max_devices):
                continue
            if self._modeled_norm(recv, k_recv + 1) \
                    >= self._modeled_norm(recv, k_recv) - _EPS:
                continue            # another device would not help
            donor = self._pick_donor(recv, norms)
            if donor is not None:
                return {"from": donor, "to": recv}
        return None

    def _pick_donor(self, recv: str,
                    norms: Dict[str, float]) -> Optional[str]:
        pol = self.policy
        best, best_key = None, None
        for name in self.fleet.member_names:
            if name == recv:
                continue
            k = self.device_counts[name]
            floor = max(1, self.fleet.member(name).min_devices)
            if k - 1 < floor:
                continue
            modeled_after = self._modeled_norm(name, k - 1)
            if modeled_after > 1.0 / pol.donor_headroom:
                continue
            obs = norms.get(name, 0.0)
            if obs > pol.violation_threshold:
                continue            # already struggling; not a donor
            key = (modeled_after, obs, name)   # name: deterministic tie
            if best_key is None or key < best_key:
                best, best_key = name, key
        return best

    def _execute(self, move: Dict[str, str],
                 norms: Dict[str, float]) -> Dict[str, Any]:
        donor, recv = move["from"], move["to"]
        try:
            self._resize(donor, self.device_counts[donor] - 1)
            self._resize(recv, self.device_counts[recv] + 1)
        except Exception as e:
            # a failed resize leaves counts consistent (_resize updates
            # the count only after the reconfigure lands)
            self._cooldown = self.policy.cooldown_ticks
            return self._note("move_failed", move=dict(move),
                              error=repr(e))
        self._pending = {
            "move": dict(move),
            "ticks_left": self.policy.guard_ticks,
            "pre_recv": norms.get(recv),
            "pre_donor": norms.get(donor),
        }
        # the swap window's telemetry is noise; restart the EWMA for the
        # moved pair so the guard judges post-move windows only
        self._norm_ewma[donor] = None
        self._norm_ewma[recv] = None
        return self._note("move", move=dict(move),
                          counts=dict(self.device_counts),
                          guard_ticks=self.policy.guard_ticks)

    def _advance_guard(self, norms: Dict[str, float]) -> Dict[str, Any]:
        pol = self.policy
        pend = self._pending
        pend["ticks_left"] -= 1
        if pend["ticks_left"] > 0:
            return self._note("guard", move=dict(pend["move"]),
                              ticks_left=pend["ticks_left"])
        self._pending = None
        self._cooldown = pol.cooldown_ticks
        donor, recv = pend["move"]["from"], pend["move"]["to"]
        post_recv = norms.get(recv)
        post_donor = norms.get(donor)
        pre_recv = pend["pre_recv"]
        recv_ok = (
            post_recv is None           # no pressure left at all
            or post_recv <= pol.violation_threshold
            or (pre_recv is not None
                and post_recv <= pre_recv * (1 - pol.min_improvement)))
        donor_ok = (post_donor is None
                    or post_donor <= pol.violation_threshold
                    or (post_recv is not None
                        and post_donor <= post_recv))
        if recv_ok and donor_ok:
            return self._note("commit", move=dict(pend["move"]),
                              counts=dict(self.device_counts),
                              post_recv=post_recv, post_donor=post_donor)
        try:
            self._resize(recv, self.device_counts[recv] - 1)
            self._resize(donor, self.device_counts[donor] + 1)
        except Exception as e:
            return self._note("rollback_failed", move=dict(pend["move"]),
                              error=repr(e))
        self._norm_ewma[donor] = None
        self._norm_ewma[recv] = None
        return self._note("rollback", move=dict(pend["move"]),
                          counts=dict(self.device_counts),
                          post_recv=post_recv, post_donor=post_donor)

    def _resize(self, name: str, k: int) -> None:
        self._deps[name].reconfigure(stages=k)
        self.device_counts[name] = k

    def _note(self, kind: str, **fields) -> Dict[str, Any]:
        ev = {"tick": self._tick_no, "event": kind, **fields}
        self.events.append(ev)
        return ev

    @property
    def committed_moves(self) -> int:
        return sum(1 for e in self.events if e["event"] == "commit")

    # -- thread wrapper ------------------------------------------------------
    def start(self, interval_s: float = 1.0) -> "FleetAutoscaler":
        if self._thread is not None:
            return self
        self._stop_evt.clear()

        def loop():
            while not self._stop_evt.wait(interval_s):
                try:
                    self.tick()
                except Exception:
                    pass        # a bad tick must not kill the loop

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="fleet-autoscale")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "FleetAutoscaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
