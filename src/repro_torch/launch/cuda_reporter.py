"""The card's MemoryReporter for the §6.1.3 refinement loop.

On the Edge TPU the paper compiles each candidate segment and reads the
compiler's memory report; ``repro/launch/xla_reporter.py`` compiles the
segment's stage function and reads XLA's ``memory_analysis()``.  On the
card the segment is run instead: its blocks' weights and an input are
allocated on the device, the blocks run once, and the caching allocator's
peak above its level before the allocation is the segment's bytes
(weights, input, activations and workspace: the counterpart of XLA's
argument, output and temp bytes).  Overflow is the bytes beyond the
per-device budget.  It measures, and never estimates: on a device other
than a card it raises.

The reporter plugs in wherever a :class:`~repro_torch.core.refine.
MemoryReporter` does: ``plan(spec, graph=..., reporter=...)``,
``deploy(..., reporter=...)`` and :func:`repro_torch.core.refine.
refine_cuts`::

    g = lm_graph.lm_layer_graph(cfg, seq_len=1024)
    rep = CudaSegmentReporter(cfg, g, budget_bytes=2 << 30, seq=1024)
    res = refine_cuts(cuts, len(g.levels()), rep)
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core.graph import LayerGraph
from ..models import lm
from ..models.lm import LMConfig


class CudaSegmentReporter:
    """MemoryReporter over runs of block ranges on the card (an attention
    family's ``block_i`` nodes).  ``compilations`` counts the runs (one per
    distinct depth range; repeated queries are cached)."""

    def __init__(self, cfg: LMConfig, graph: LayerGraph, budget_bytes: int,
                 batch: int = 1, seq: int = 128, device="cuda"):
        lm.require_ported(cfg, lm.ATTN_FAMILIES)
        self.cfg = cfg
        self.graph = graph
        self.budget = budget_bytes
        self.batch = batch
        self.seq = seq
        self.device = torch.device(device)
        self._levels = graph.levels()
        self._bytes_per_depth = graph.bytes_per_depth()
        self._cache: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self._warm = False
        self.compilations = 0

    def _block_range(self, depth_lo: int, depth_hi: int) -> Tuple[int, int]:
        """Map a depth range to a [lo, hi) block index range."""
        names = [n for lvl in self._levels[depth_lo:depth_hi + 1]
                 for n in lvl if n.startswith("block_")]
        if not names:
            return (0, 0)
        idxs = sorted(int(n.split("_")[1]) for n in names)
        return idxs[0], idxs[-1] + 1

    def _measure(self, n_blocks: int) -> int:
        """Peak bytes the allocator held, above its level before, while
        ``n_blocks`` blocks with random weights (seed 0) ran on a (batch,
        seq, d_model) input; everything allocated is freed before
        returning.  The first call runs one block unmeasured first, so the
        process's one-time allocations (the BLAS library's workspace of
        the stream, which stays allocated) count in no segment."""
        if self.device.type != "cuda":
            raise ValueError(f"CudaSegmentReporter measures on the card; "
                             f"device {str(self.device)!r} is not one")
        if not self._warm:
            self._run(1)
            self._warm = True
        return self._run(n_blocks)

    def _run(self, n_blocks: int) -> int:
        dev, cfg = self.device, self.cfg
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        gen = torch.Generator(dev).manual_seed(0)
        with torch.inference_mode():
            blocks = [lm.block_params(cfg, cfg.dtype, dev, gen)
                      for _ in range(n_blocks)]
            x = torch.randn(self.batch, self.seq, cfg.d_model,
                            generator=gen, device=dev).to(cfg.dtype)
            pos = lm.positions_for(cfg, x)
            for bp in blocks:
                x = lm.block(cfg, bp, x, pos)
            torch.cuda.synchronize(dev)
            used = torch.cuda.max_memory_allocated(dev) - base
        del blocks, x, pos
        return int(used)

    def segment_report(self, depth_lo: int, depth_hi: int) -> Tuple[int, int]:
        key = (depth_lo, depth_hi)
        if key in self._cache:
            return self._cache[key]
        lo, hi = self._block_range(depth_lo, depth_hi)
        used = self._measure(max(1, hi - lo))
        self.compilations += 1
        over = max(0, used - self.budget)
        self._cache[key] = (min(used, self.budget), over)
        return self._cache[key]

    def depth_bytes(self, depth: int) -> int:
        return self._bytes_per_depth[depth]
