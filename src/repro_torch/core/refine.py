"""Segmentation refinement (paper §6.1.3, Fig. 9).

The balanced split of Algorithm 1 equalizes *parameter counts*, but the
compiled per-segment memory also includes activations, instructions, padding
and alignment — only visible after compiling each segment.  The paper uses the
Edge TPU compiler's memory report as feedback and nudges cut positions until
no segment spills to host memory:

* **forward sweep** (first → last segment): if segment ``S_i`` spills, move
  the cut between ``S_i`` and ``S_{i+1}`` one depth *earlier* (shrinking
  ``S_i``); repeat until ``S_i`` fits, then advance to ``S_{i+1}``.
* **backward sweep** (last → first): the forward sweep pushes layers toward
  the last segment; if the *last* segment spills, sweep backwards moving cuts
  one depth *later* (shrinking from the left).

The reporter is pluggable: benchmarks/tests use the analytical
:class:`~repro_torch.core.edge_tpu_model.EdgeTPUModel` reporter (playing the Edge
TPU compiler's role); the pod-scale path uses XLA ``memory_analysis()``
(see launch/xla_reporter.py).  The optimization noted at the end of §6.1.3 —
moving a cut several positions per compilation, sized by the spill amount —
is implemented and on by default (``multi_step=True``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Protocol, Sequence, Tuple

from .segmentation import segment_ranges


class MemoryReporter(Protocol):
    """Compile (or estimate) one segment and report its memory usage."""

    def segment_report(self, depth_lo: int, depth_hi: int) -> Tuple[int, int]:
        """Returns (device_bytes, host_overflow_bytes) for depths [lo, hi]."""
        ...

    def depth_bytes(self, depth: int) -> int:
        """Weight bytes contributed by one depth level (for multi-step moves)."""
        ...


@dataclasses.dataclass
class RefinementResult:
    cuts: List[int]
    compilations: int       # number of reporter calls (§6.1.3 cost metric)
    moves: int
    converged: bool         # True iff no segment spills


def _spill(reporter: MemoryReporter, lo: int, hi: int) -> int:
    return reporter.segment_report(lo, hi)[1]


def _steps_for_spill(reporter: MemoryReporter, spill: int,
                     depths: Sequence[int]) -> int:
    """How many depth levels (from `depths`, in move order) to shed to cover
    `spill` bytes — the §6.1.3 multi-position optimization."""
    shed, steps = 0, 0
    for d in depths:
        if shed >= spill:
            break
        shed += reporter.depth_bytes(d)
        steps += 1
    return max(1, steps)


def refine_cuts(
    cuts: Sequence[int],
    n_levels: int,
    reporter: Optional[MemoryReporter] = None,
    max_rounds: int = 8,
    multi_step: bool = True,
    stage_reporters: Optional[Sequence[MemoryReporter]] = None,
) -> RefinementResult:
    """Run forward/backward refinement sweeps until no segment spills.

    ``reporter`` prices every segment against one device (the paper's
    homogeneous chain).  ``stage_reporters`` instead supplies one reporter
    *per stage* — per-stage device limits for heterogeneous topologies
    (e.g. built by ``TopologyCostModel.stage_reporters``); stage ``i``'s
    spill is judged against its own device's capacity.  Exactly one of the
    two must be given.
    """
    cuts = list(cuts)
    s = len(cuts) + 1
    if (reporter is None) == (stage_reporters is None):
        raise ValueError("pass exactly one of reporter / stage_reporters")
    if stage_reporters is not None and len(stage_reporters) != s:
        raise ValueError(f"need {s} stage reporters, got "
                         f"{len(stage_reporters)}")
    rep_for = ((lambda i: reporter) if stage_reporters is None
               else (lambda i: stage_reporters[i]))
    compilations = 0
    moves = 0

    def ranges() -> List[Tuple[int, int]]:
        return segment_ranges(n_levels, cuts)

    for _ in range(max_rounds):
        dirty = False

        # ---- forward sweep: shrink spilling segments from the right --------
        for i in range(s - 1):                    # segments that own a right cut
            while True:
                lo, hi = ranges()[i]
                compilations += 1
                spill = _spill(rep_for(i), lo, hi)
                if spill <= 0:
                    break
                if hi <= lo:                      # cannot shrink a 1-level segment
                    break
                if multi_step:
                    step = _steps_for_spill(
                        rep_for(i), spill, range(hi, lo, -1))
                    step = min(step, hi - lo)
                else:
                    step = 1
                # move this segment's right cut `step` levels earlier
                new_cut = cuts[i] - step
                floor = cuts[i - 1] + 1 if i > 0 else 0
                cuts[i] = max(new_cut, floor)
                moves += 1
                dirty = True

        # ---- backward sweep: shrink spilling segments from the left ---------
        for i in range(s - 1, 0, -1):             # segments that own a left cut
            while True:
                lo, hi = ranges()[i]
                compilations += 1
                spill = _spill(rep_for(i), lo, hi)
                if spill <= 0:
                    break
                if hi <= lo:
                    break
                if multi_step:
                    step = _steps_for_spill(rep_for(i), spill, range(lo, hi))
                    step = min(step, hi - lo)
                else:
                    step = 1
                # move this segment's left cut `step` levels later
                new_cut = cuts[i - 1] + step
                ceil = cuts[i] - 1 if i < s - 1 else n_levels - 2
                cuts[i - 1] = min(new_cut, ceil)
                moves += 1
                dirty = True

        # check convergence
        ok = True
        for i, (lo, hi) in enumerate(ranges()):
            compilations += 1
            if _spill(rep_for(i), lo, hi) > 0:
                ok = False
                break
        if ok:
            return RefinementResult(cuts=cuts, compilations=compilations,
                                    moves=moves, converged=True)
        if not dirty:
            break   # stuck: no cut can move further

    return RefinementResult(cuts=cuts, compilations=compilations,
                            moves=moves, converged=False)


class GraphReporter:
    """MemoryReporter over an analytical EdgeTPUModel (or any object exposing
    ``segment_memory`` + a LayerGraph) — used by tests and CNN benchmarks.

    Per-depth weight bytes come from the model's segment-cost engine when
    it uses one, so the refiner's multi-step move sizing uses the exact
    bytes accounting of the planner's cost source (one model, no
    duplicated size math); objects without an engine — and the naive
    ``use_engine=False`` baseline models, which must not silently build
    one — fall back to the graph's own per-depth array, the same numbers
    for the analytic source."""

    def __init__(self, tpu_model):
        self._m = tpu_model
        engine = (getattr(tpu_model, "engine", None)
                  if getattr(tpu_model, "use_engine", True) else None)
        self._bytes_per_depth = (engine.depth_weight_bytes()
                                 if engine is not None
                                 else tpu_model.graph.bytes_per_depth())

    def segment_report(self, depth_lo: int, depth_hi: int) -> Tuple[int, int]:
        # fast path: bytes-only query, no per-layer placement dict
        fast = getattr(self._m, "segment_report_bytes", None)
        if fast is not None:
            return fast(depth_lo, depth_hi)
        rep = self._m.segment_memory(depth_lo, depth_hi)
        return rep.device_bytes, rep.host_bytes

    def depth_bytes(self, depth: int) -> int:
        return self._bytes_per_depth[depth]
