"""KV-cache-aware decode placement: maximize steady-state tokens/s.

The paper's strategies balance static weights (or prefill time) against
on-chip memory.  At a decode operating point the binding constraint moves:
every attention layer a stage holds pins ``concurrency x context x KV-row``
bytes of cache on-device, and whatever the cache displaces from the weight
budget must be re-streamed over PCIe each step.  ``decode_placement``
prices both effects on the existing minimax DP skeleton:

* a segment whose KV (at the operating point) exceeds the on-chip budget
  is **infeasible** (cost = inf) — the per-stage KV cap;
* a feasible segment's cost is one decode *step* of the whole running
  batch (``DecodeCostSource`` time) plus PCIe streaming of the weights
  the KV displaced from on-chip capacity;
* the DP minimizes the max stage cost — steady-state tokens/s is
  ``concurrency / max_stage_step_time``, so minimax *is* the tokens/s
  maximizer — and the result is compared against the weight-balanced
  (Algorithm 1) cuts priced under the same decode cost, keeping the
  ``opt``-style hard never-worse guarantee.

The plan carries a ``decode_info`` dict (per-stage KV bytes, caps,
headroom, modeled tokens/s) that ``repro_torch.api.plan`` folds into the
:class:`~repro_torch.api.report.PlanReport`.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from ..core.edge_tpu_model import EdgeTPUModel, EdgeTPUSpec
from ..core.placement import PlacementPlan
from ..core.segmentation import (balanced_split, minimax_time_split,
                                 segment_ranges)
from ..models.lm import LMConfig
from .costing import DecodeCostSource, DecodeOperatingPoint

# defaults when the spec leaves the operating point open
DEFAULT_CONCURRENCY = 4
DEFAULT_MAX_CONTEXT = 256

# families the *runtime* decode engine executes (scan-block KV decode);
# planning covers every family — recurrent ones as O(1)-state blocks
DECODE_FAMILIES = ("dense", "moe", "vlm")


def decode_config_for(model: Optional[str]) -> LMConfig:
    """Resolve a spec's ``lm:`` ref to its smoke LMConfig, with an
    actionable error for anything else."""
    if model is None or not model.startswith("lm:"):
        raise ValueError(
            f"decode placement needs an 'lm:<arch>' model ref (the decode "
            f"cost regime is derived from the LM config: KV heads, head "
            f"dim, window, family); got {model!r}. Pick an arch from "
            f"repro_torch.configs.arch_ids(), e.g. model='lm:qwen3-1.7b'")
    from .. import configs
    arch = model[len("lm:"):].partition(":")[0]
    return configs.get(arch).smoke_config()


def operating_point(spec) -> DecodeOperatingPoint:
    """The (concurrency, max_context) point a spec asks to be planned at
    (falling back to the module defaults)."""
    return DecodeOperatingPoint(
        concurrency=spec.decode_concurrency or DEFAULT_CONCURRENCY,
        max_context=spec.max_context or DEFAULT_MAX_CONTEXT)


def kv_budget_bytes(base: EdgeTPUSpec) -> int:
    """On-chip bytes a stage may spend on decode state."""
    return base.onchip_bytes - base.fixed_reserve


def max_feasible_concurrency(engine, cuts: List[int],
                             base: EdgeTPUSpec) -> int:
    """Largest concurrency the plan's stages can hold at the engine's
    operating context (KV cap only; 0 means even one sequence spills)."""
    budget = kv_budget_bytes(base)
    out = math.inf
    for lo, hi in segment_ranges(engine.depth, cuts):
        per_seq = engine.segment_state_bytes(lo, hi)
        if per_seq > 0:
            out = min(out, budget // per_seq)
    return int(out) if out is not math.inf else 2 ** 30


def step_cost_fn(engine, base: EdgeTPUSpec, point: DecodeOperatingPoint):
    """The decode stage-cost model: one step of the whole running batch
    over a segment, inf past the KV cap.  Shared by the strategy's DP and
    the benchmark's weight-balanced baseline (both price under the *same*
    cost, so the comparison is apples to apples)."""
    budget = kv_budget_bytes(base)
    n = point.concurrency
    pcie = base.pcie_gbps * 1e9

    def stage_cost(lo: int, hi: int) -> float:
        kv = n * engine.segment_state_bytes(lo, hi)
        if kv > budget:
            return math.inf          # per-stage KV cap
        t = engine.segment_time(lo, hi)
        # KV displaces weights from on-chip capacity: whatever the greedy
        # placement kept on-device past the shrunken budget is
        # re-streamed every step
        dev, host = engine.segment_split(lo, hi)
        allowed = max(0, engine.segment_capacity(lo, hi) - kv)
        extra = max(0, dev - allowed)
        if extra > 0:
            t += extra / pcie
            if host == 0:
                t += base.spill_event_overhead_s
        return t

    return stage_cost


def _register() -> None:
    """Register the strategy (deferred: repro_torch.api.strategies imports
    the spec module, so a module-level import here would cycle through
    repro_torch.api.__init__)."""
    from ..api.strategies import PlanStrategy, register_strategy

    @register_strategy("decode_placement")
    class DecodePlacementStrategy(PlanStrategy):
        objective = "max_decode_tokens_per_s"

        def plan(self, ctx) -> PlacementPlan:
            spec = ctx.spec
            # the config beside a caller's graph (plan(..., cfg=)) prices
            # that graph's KV rows; else the spec's ref, as the reference
            cfg = (decode_config_for(spec.model) if ctx.cfg is None
                   else ctx.cfg)
            point = operating_point(spec)
            base = ctx.device_base_spec() or EdgeTPUSpec()
            src = DecodeCostSource(cfg, point)
            model = EdgeTPUModel(ctx.graph, base, cost_source=src)
            eng = model.engine
            depth = ctx.graph.depth
            budget = kv_budget_bytes(base)
            n = point.concurrency
            stage_cost = step_cost_fn(eng, base, point)

            s = spec.stages
            if s is None:
                topo = spec.resolved_topology()
                s = topo.n_devices if topo is not None else None
            if s is None:
                # auto: smallest stage count whose best split fits the
                # KV cap (decode's analog of the §5.2.2 no-spill rule)
                for cand in range(1, depth + 1):
                    cuts = minimax_time_split(depth, cand, stage_cost,
                                              exact=True)
                    if max(stage_cost(lo, hi) for lo, hi
                           in segment_ranges(depth, cuts)) < math.inf:
                        s = cand
                        break
                else:
                    s = depth
            else:
                cuts = minimax_time_split(depth, s, stage_cost,
                                          exact=True)

            costs = [stage_cost(lo, hi)
                     for lo, hi in segment_ranges(depth, cuts)]
            if max(costs) == math.inf:
                raise ValueError(
                    f"no feasible decode placement for {cfg.name} at "
                    f"concurrency={n}, max_context={point.max_context} "
                    f"with {s} stages (some stage's KV exceeds the "
                    f"{budget} byte on-chip budget); add stages, lower "
                    f"decode_concurrency, or lower max_context")

            # hard guarantee: never worse than the weight-balanced cuts
            # priced under the same decode cost (the bench baseline)
            bal = balanced_split(ctx.graph.params_per_depth(), s)
            bal_costs = [stage_cost(lo, hi)
                         for lo, hi in segment_ranges(depth, bal)]
            if max(bal_costs) < max(costs):
                cuts, costs = bal, bal_costs

            pl = PlacementPlan.from_cuts(
                ctx.graph, cuts, strategy="decode_placement",
                tpu_model=model)
            pl.decode_info = decode_info(eng, cuts, point, base, costs)
            return pl


def decode_info(engine, cuts: List[int], point: DecodeOperatingPoint,
                base: EdgeTPUSpec,
                stage_costs: Optional[List[float]] = None) -> Dict:
    """The decode columns of a plan's report: per-stage KV at the
    operating point, the cap, headroom, and modeled steady-state
    tokens/s."""
    budget = kv_budget_bytes(base)
    ranges = segment_ranges(engine.depth, cuts)
    kv = [point.concurrency * engine.segment_state_bytes(lo, hi)
          for lo, hi in ranges]
    if stage_costs is None:
        stage_costs = [engine.segment_time(lo, hi) for lo, hi in ranges]
    pace = max(stage_costs)
    tps = (point.concurrency / pace
           if pace > 0 and pace != math.inf else 0.0)
    headroom = min((budget - b) / budget * 100.0 for b in kv)
    return {
        "decode_tokens_per_s": tps,
        "decode_concurrency": point.concurrency,
        "decode_max_context": point.max_context,
        "stage_kv_bytes": tuple(kv),
        "stage_kv_cap_bytes": tuple([budget] * len(kv)),
        "kv_headroom_pct": headroom,
    }
