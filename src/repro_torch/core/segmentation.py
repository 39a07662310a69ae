"""Segmentation strategies (paper §5–§6).

All strategies partition the per-depth cost array ``P`` (``P[i]`` = parameters
at depth ``i``) into ``s`` contiguous segments by choosing ``s-1`` horizontal
cut positions.  A "cut position" ``c`` means the cut lies *after* depth ``c``,
so cuts ``[c0 < c1 < ...]`` produce segments ``[0..c0], [c0+1..c1], ...``.

Strategies:

* :func:`balanced_split` — the paper's Algorithm 1 (SEGM_BALANCED step 2):
  minimize the maximum segment sum via binary search over the bound plus a
  greedy feasibility check.  O(d log ΣP).
* :func:`comp_split` — model of the Edge TPU compiler (SEGM_COMP): balances
  layer *count* per segment, ignoring sizes (paper §5.2: "the compiler
  balances the number of layers in the segments, but not the number of model
  parameters").
* :func:`prof_split` — SEGM_PROF: exhaustive search over all C(d-1, s-1) cut
  placements, scoring each candidate with a caller-supplied cost function
  (the paper profiles real executions; we plug in the analytical Edge TPU
  pipeline model).  Only feasible for shallow models.
* :func:`dp_split` — exact minimax partition via dynamic programming,
  O(d^2 s).  Used as a property-test oracle for ``balanced_split``.
* :func:`placement_split` — BEYOND-PAPER joint search over cuts *and*
  per-stage replica counts under a fixed device budget (heterogeneous
  chain topologies; see core/topology.py and the planner's
  ``plan_placement``).
"""
from __future__ import annotations

import bisect
import itertools
from typing import Callable, List, Optional, Sequence, Tuple


def _validate(P: Sequence[int], s: int) -> None:
    if s < 1:
        raise ValueError(f"segments must be >= 1, got {s}")
    if len(P) == 0:
        raise ValueError("empty cost array")
    if s > len(P):
        raise ValueError(f"cannot split {len(P)} depth levels into {s} segments")
    if any(p < 0 for p in P):
        raise ValueError("cost array entries must be non-negative")


def split_check(P: Sequence[int], bound: int, s: int) -> Tuple[bool, List[int]]:
    """Greedy feasibility check (paper Algorithm 1, ``splitCheck``).

    Traverses ``P`` accumulating values into the current segment; opens a new
    segment whenever the running sum would exceed ``bound``.  Returns
    ``(feasible, cut_positions)`` where feasible means at most ``s`` segments
    were needed.
    """
    min_segms = 0
    params_sum = 0
    split_pos: List[int] = []
    for i, p in enumerate(P):
        params_sum += p
        if params_sum > bound:
            split_pos.append(i - 1)      # cut just before this depth
            min_segms += 1
            params_sum = p
    min_segms += 1                       # the last segment
    return min_segms <= s, split_pos


def _prefix_split_check(prefix: Sequence[int], bound: int,
                        s: int) -> Tuple[bool, List[int]]:
    """`split_check` over a precomputed prefix-sum array, one bisect per
    segment instead of a full traversal: O(s log d).

    Exactly equivalent to the greedy when ``bound >= max(P)`` (each greedy
    segment is the maximal prefix summing to <= bound) — which
    ``balanced_split``'s binary search guarantees.
    """
    d = len(prefix) - 1
    segs = 0
    start = 0
    cuts: List[int] = []
    while start < d:
        i = bisect.bisect_right(prefix, prefix[start] + bound,
                                start + 1, d + 1) - 1
        segs += 1
        if i >= d:
            break
        cuts.append(i - 1)
        start = i
    return segs <= s, cuts


def _greedy_cuts_exact(P: Sequence[int], bound: int, s: int) -> List[int]:
    """Greedy cuts for a known-feasible bound, padded to exactly s-1 cuts.

    ``split_check`` may need fewer than ``s`` segments; downstream code wants
    exactly ``s`` stages (one per device), so we split the largest remaining
    segments at valid positions (or emit empty segments only when unavoidable,
    which cannot happen because s <= len(P)).
    """
    ok, cuts = split_check(P, bound, s)
    assert ok
    cuts = list(cuts)
    # pad: split segments with >1 depth level until we have s-1 cuts
    while len(cuts) < s - 1:
        bounds = [-1] + cuts + [len(P) - 1]
        # candidate extra cut inside the widest segment
        best: Optional[Tuple[int, int]] = None  # (width, cut_pos)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            width = hi - lo
            if width >= 2:
                cand = (width, lo + (width // 2))
                if best is None or cand[0] > best[0]:
                    best = cand
        if best is None:  # all segments are single-level: impossible since s<=len(P)
            raise AssertionError("cannot pad cuts; s > len(P)?")
        cuts.append(best[1])
        cuts.sort()
    return cuts


def balanced_split(P: Sequence[int], s: int,
                   tie_break: str = "late") -> List[int]:
    """Paper Algorithm 1 (``balancedSplit``): minimax partition of ``P``.

    Binary-searches the smallest ``bound`` such that ``P`` splits into at most
    ``s`` segments each summing to ``<= bound``; returns the s-1 cut positions.

    ``tie_break="late"`` (default) selects, among minimax-optimal splits,
    the one produced by a *backward* greedy pass — slack accumulates in the
    early segments and weight in the late ones.  The last pipeline stage has
    no output transfer, so late-heavy optimal splits give slightly better
    stage times (a tie-break the paper's forward greedy leaves on the
    table; both variants achieve the same optimal bound).
    ``tie_break="early"`` reproduces the paper's forward greedy exactly.
    """
    _validate(P, s)
    if s == 1:
        return []
    prefix = list(itertools.accumulate(P, initial=0))
    lo = max(P)                 # an upper bound must exceed every element
    hi = prefix[-1]             # the array sum is an obvious upper bound
    best_bound = hi
    while lo <= hi:
        bound = (lo + hi) // 2
        ok, _ = _prefix_split_check(prefix, bound, s)
        if ok:
            best_bound = bound
            hi = bound - 1      # search for smaller upper bounds
        else:
            lo = bound + 1
    if tie_break == "late":
        d = len(P)
        rprefix = list(itertools.accumulate(reversed(P), initial=0))
        ok, rcuts = _prefix_split_check(rprefix, best_bound, s)
        if ok:
            cuts = sorted(d - 2 - c for c in rcuts)
            if all(0 <= c < d - 1 for c in cuts):
                cuts = _pad_cuts(P, cuts, s, best_bound)
                if cuts is not None:
                    return cuts
    return _greedy_cuts_exact(P, best_bound, s)


def _pad_cuts(P: Sequence[int], cuts: List[int], s: int,
              bound: int) -> Optional[List[int]]:
    """Pad a valid cut list to exactly s-1 cuts without exceeding bound.

    Extra cuts go into the widest segment, placed as LATE as the bound
    allows (late-heavy tie-break: the final pipeline stage has no output
    transfer, so weight should sit late)."""
    cuts = sorted(set(cuts))
    while len(cuts) < s - 1:
        bounds = [-1] + cuts + [len(P) - 1]
        widest = None
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            width = hi - lo
            if width >= 2 and (widest is None or width > widest[0]):
                widest = (width, lo, hi)
        if widest is None:
            return None
        _, lo, hi = widest
        # latest cut c in (lo, hi) with sum(P[lo+1..c]) <= bound
        pos = None
        run = 0
        for c in range(lo + 1, hi):
            run += P[c]
            if run <= bound:
                pos = c
            else:
                break
        if pos is None:
            pos = lo + 1
        cuts.append(pos)
        cuts.sort()
    if max_segment(P, cuts) > bound:
        return None
    return cuts


def comp_split(P: Sequence[int], s: int) -> List[int]:
    """SEGM_COMP model: equal layer-count segments (paper §5.2 observation).

    Matches the observed vendor behaviour: d levels split as evenly as
    possible by *count*; remainders go to the LAST segments (the paper's
    Table 4 shows a 1-1-1-2 split of 5 layers — the extra layer lands at the
    end, overloading the final TPU).
    """
    _validate(P, s)
    d = len(P)
    base, rem = divmod(d, s)
    sizes = [base] * (s - rem) + [base + 1] * rem   # extras at the end
    cuts, pos = [], 0
    for size in sizes[:-1]:
        pos += size
        cuts.append(pos - 1)
    return cuts


def segment_sums(P: Sequence[int], cuts: Sequence[int]) -> List[int]:
    """Per-segment sums given cut positions."""
    bounds = [-1] + list(cuts) + [len(P) - 1]
    return [sum(P[lo + 1:hi + 1]) for lo, hi in zip(bounds[:-1], bounds[1:])]


def segment_ranges(n_levels: int, cuts: Sequence[int]) -> List[Tuple[int, int]]:
    """[(depth_lo, depth_hi)] per segment (inclusive)."""
    bounds = [-1] + list(cuts) + [n_levels - 1]
    return [(lo + 1, hi) for lo, hi in zip(bounds[:-1], bounds[1:])]


def max_segment(P: Sequence[int], cuts: Sequence[int]) -> int:
    return max(segment_sums(P, cuts))


def imbalance(P: Sequence[int], cuts: Sequence[int]) -> int:
    """Δs of the paper's Table 5: largest minus smallest segment size."""
    sums = segment_sums(P, cuts)
    return max(sums) - min(sums)


def prof_split(
    P: Sequence[int],
    s: int,
    cost_fn: Callable[[List[int]], float],
    max_candidates: int = 2_000_000,
) -> List[int]:
    """SEGM_PROF (paper §5.3): exhaustive profiling over all cut placements.

    ``cost_fn(cuts)`` models one profiled pipeline execution (lower = better).
    Raises if the search space exceeds ``max_candidates`` — the paper's point
    is precisely that this explodes for deep models (>3e9 for ResNet101 s=6).
    """
    _validate(P, s)
    d = len(P)
    import math
    n_cand = math.comb(d - 1, s - 1)
    if n_cand > max_candidates:
        raise ValueError(
            f"SEGM_PROF infeasible: C({d-1},{s-1}) = {n_cand} candidate "
            f"partitions exceeds limit {max_candidates} (paper §5.3)")
    best_cuts: Optional[List[int]] = None
    best_cost = float("inf")
    for combo in itertools.combinations(range(d - 1), s - 1):
        cuts = list(combo)
        c = cost_fn(cuts)
        if c < best_cost:
            best_cost, best_cuts = c, cuts
    assert best_cuts is not None
    return best_cuts


def minimax_time_split(
    d: int,
    s: int,
    cost_fn: Callable[[int, int], float],
    exact: bool = False,
) -> List[int]:
    """Minimax partition of depths [0..d-1] under an arbitrary range cost.

    ``cost_fn(lo, hi)`` is the modeled *stage time* of the segment covering
    depths [lo, hi] inclusive (compute + weight-load + stream + I/O via the
    SegmentCostEngine); the DP minimizes the maximum stage cost over all
    contiguous s-way partitions — the quantity that paces a pipeline.

    dp[k][i] = min over j of max(dp[k-1][j], cost(j+1, i)).  The fast path
    exploits that dp[k-1][j] is non-decreasing in j while cost(j+1, i) is
    non-increasing in j (both hold exactly for cumulative costs; the stage
    I/O boundary term can perturb them locally), binary-searching the
    crossing point per cell: O(d·s·log d) cost evaluations, each O(1) on the
    engine.  ``exact=True`` scans every j — O(d²·s) — and is the oracle the
    tests compare against.  Callers wanting a hard never-worse-than-balanced
    guarantee compare the result against Algorithm 1's cuts (planner "opt"
    does exactly that).
    """
    if s < 1:
        raise ValueError(f"segments must be >= 1, got {s}")
    if d < 1:
        raise ValueError("empty depth range")
    if s > d:
        raise ValueError(f"cannot split {d} depth levels into {s} segments")
    if s == 1:
        return []

    memo: dict = {}

    def cost(lo: int, hi: int) -> float:
        key = (lo, hi)
        v = memo.get(key)
        if v is None:
            v = memo[key] = cost_fn(lo, hi)
        return v

    INF = float("inf")
    prev = [cost(0, i) for i in range(d)]        # k = 1
    back: List[List[int]] = [[-1] * d for _ in range(s + 1)]
    for k in range(2, s + 1):
        cur = [INF] * d
        for i in range(k - 1, d):
            jlo, jhi = k - 2, i - 1
            if exact:
                best, best_j = INF, jlo
                for j in range(jlo, jhi + 1):
                    c = max(prev[j], cost(j + 1, i))
                    if c < best:
                        best, best_j = c, j
            else:
                # smallest j where the (non-decreasing) prefix optimum
                # overtakes the (non-increasing) last-segment cost
                lo_j, hi_j = jlo, jhi
                while lo_j < hi_j:
                    mid = (lo_j + hi_j) // 2
                    if prev[mid] >= cost(mid + 1, i):
                        hi_j = mid
                    else:
                        lo_j = mid + 1
                best, best_j = INF, jlo
                for j in (lo_j - 1, lo_j, lo_j + 1):   # hedge local wobbles
                    if jlo <= j <= jhi:
                        c = max(prev[j], cost(j + 1, i))
                        if c < best:
                            best, best_j = c, j
            cur[i] = best
            back[k][i] = best_j
        prev = cur

    cuts: List[int] = []
    i = d - 1
    for k in range(s, 1, -1):
        j = back[k][i]
        cuts.append(j)
        i = j
    cuts.reverse()
    return cuts


def placement_split(
    d: int,
    n_devices: int,
    cost_fn: Callable[[int, int, int, int], float],
    max_replicas: Optional[int] = None,
) -> Tuple[List[int], List[int]]:
    """Joint minimax search over cuts AND per-stage replica counts.

    Generalizes :func:`minimax_time_split` from "s stages, one device each"
    to a fixed *device budget*: stages consume consecutive runs of devices
    from an ordered topology, a stage may take ``k`` devices (``k``
    replicas, round-robin traffic split), and the number of stages is free
    (1..n_devices).  ``cost_fn(lo, hi, dev_lo, k)`` is the *effective*
    pacing time of depths [lo, hi] replicated over devices
    [dev_lo, dev_lo + k) — +inf marks an inadmissible device grouping
    (e.g. non-identical devices in one replica group).

    dp[n][i] = best max effective stage cost covering depths [0..i] with
    exactly the first ``n`` devices; transitions try every (last-stage
    start j+1, replica count k).  The answer takes the best ``n <=
    n_devices`` — a trailing device that does not help stays idle.  Exact
    search, O(d^2 · n^2) cost evaluations (each O(1) on the engine):
    the planner runs it for single-digit device budgets where this is
    milliseconds-to-seconds even for the deepest Table-1 models.

    Returns ``(cuts, replicas)`` — ``len(replicas) == len(cuts) + 1`` and
    ``sum(replicas) <= n_devices``.  With ``max_replicas=1`` this is an
    exact non-replicated minimax over at most ``n_devices`` stages.
    """
    if d < 1:
        raise ValueError("empty depth range")
    if n_devices < 1:
        raise ValueError(f"device budget must be >= 1, got {n_devices}")
    rmax = n_devices if max_replicas is None else max(1, max_replicas)

    memo: dict = {}

    def cost(lo: int, hi: int, dev_lo: int, k: int) -> float:
        key = (lo, hi, dev_lo, k)
        v = memo.get(key)
        if v is None:
            v = memo[key] = cost_fn(lo, hi, dev_lo, k)
        return v

    INF = float("inf")
    # dp[n][i]; back[n][i] = (j, k): last stage covers [j+1..i] on k devices
    dp = [[INF] * d for _ in range(n_devices + 1)]
    back: List[List[Optional[Tuple[int, int]]]] = [
        [None] * d for _ in range(n_devices + 1)]
    for n in range(1, n_devices + 1):
        dpn, backn = dp[n], back[n]
        for i in range(d):
            best, best_jk = INF, None
            for k in range(1, min(n, rmax) + 1):
                rem = n - k                  # devices left of the last stage
                if rem == 0:                 # single stage covers [0..i]
                    c = cost(0, i, 0, k)
                    if c < best:
                        best, best_jk = c, (-1, k)
                    continue
                dprem = dp[rem]
                for j in range(i):
                    if dprem[j] >= INF:
                        continue
                    tail = cost(j + 1, i, rem, k)
                    c = tail if dprem[j] < tail else dprem[j]
                    if c < best:
                        best, best_jk = c, (j, k)
            dpn[i] = best
            backn[i] = best_jk

    best_n = min((n for n in range(1, n_devices + 1)
                  if dp[n][d - 1] < INF),
                 key=lambda n: dp[n][d - 1], default=None)
    if best_n is None:
        raise ValueError("no admissible placement for this topology")

    cuts: List[int] = []
    replicas: List[int] = []
    n, i = best_n, d - 1
    while True:
        j, k = back[n][i]
        replicas.append(k)
        if j < 0:
            break
        cuts.append(j)
        n, i = n - k, j
    cuts.reverse()
    replicas.reverse()
    return cuts, replicas


def dp_split(P: Sequence[int], s: int) -> List[int]:
    """Exact minimax linear partition via DP — oracle for balanced_split.

    dp[k][i] = minimal possible maximum segment sum when splitting P[0..i]
    into k segments.  O(d^2 s); fine for tests, too slow for production use.
    """
    _validate(P, s)
    d = len(P)
    prefix = [0] * (d + 1)
    for i, p in enumerate(P):
        prefix[i + 1] = prefix[i] + p

    INF = float("inf")
    dp = [[INF] * d for _ in range(s + 1)]
    cut_of = [[-1] * d for _ in range(s + 1)]
    for i in range(d):
        dp[1][i] = prefix[i + 1]
    for k in range(2, s + 1):
        for i in range(k - 1, d):
            # last segment is P[j+1..i]
            for j in range(k - 2, i):
                cand = max(dp[k - 1][j], prefix[i + 1] - prefix[j + 1])
                if cand < dp[k][i]:
                    dp[k][i] = cand
                    cut_of[k][i] = j
    # reconstruct cuts
    cuts: List[int] = []
    k, i = s, d - 1
    while k > 1:
        j = cut_of[k][i]
        cuts.append(j)
        i, k = j, k - 1
    cuts.reverse()
    return cuts
