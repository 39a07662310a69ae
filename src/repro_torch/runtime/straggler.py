"""Straggler mitigation: speculative duplicate dispatch.

For inference pipelines the slowest stage paces the whole pipeline (paper
Fig. 10).  Transient stragglers (thermal throttling on the Edge TPU — §4 —
or preempted hosts at pod scale) are mitigated by hedged execution: if a
work item has not completed within ``hedge_after`` seconds, the same item is
dispatched to a backup executor and the first result wins.  Duplicates are
safe because stages are pure functions.

The *streaming* pipeline has this built in (``PipelineExecutor``'s
``hedge_after`` — duplicates are deduplicated by the order-restoring merge);
:class:`SpeculativeExecutor` is the standalone per-call form for code that
is not running inside the executor.

"First result wins" means first *successful* result: a fast failure hedges
immediately, and the winner is the first future that completed without an
exception — a transient fault on the primary must not mask a good backup
result (and vice versa).  Only if every attempt fails does the primary's
exception propagate.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor, wait, FIRST_COMPLETED
from typing import Any, Callable, Sequence


class SpeculativeExecutor:
    def __init__(self, fn: Callable[[Any], Any], hedge_after: float = 0.05,
                 max_workers: int = 4):
        self.fn = fn
        self.hedge_after = hedge_after
        self.pool = ThreadPoolExecutor(max_workers=max_workers)
        self.hedged = 0          # number of duplicate dispatches issued
        self.completed = 0

    def submit(self, item: Any) -> Any:
        primary = self.pool.submit(self.fn, item)
        done, _ = wait([primary], timeout=self.hedge_after,
                       return_when=FIRST_COMPLETED)
        if done and primary.exception() is None:
            self.completed += 1
            return primary.result()
        # primary is straggling (or failed fast): hedge
        self.hedged += 1
        backup = self.pool.submit(self.fn, item)
        pending = {primary, backup}
        while pending:
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            for fut in done:
                if fut.exception() is None:
                    self.completed += 1
                    # leave any loser running (pure fn, result discarded)
                    return fut.result()
        # both attempts failed: surface the primary's exception
        self.completed += 1
        return primary.result()

    def map(self, items: Sequence[Any]):
        return [self.submit(x) for x in items]

    def shutdown(self, wait: bool = True):
        self.pool.shutdown(wait=wait)
