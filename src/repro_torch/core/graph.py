"""Layer graph: the model representation the segmentation algorithms operate on.

The paper (§6.1.1) treats a model as a feed-forward DAG of layers and assigns
each layer a *depth* — the maximum distance from the input, computed via a
topological order.  Segmentation then only considers *horizontal cuts*: every
open path is cut at the same depth, so a cut after depth ``i`` separates all
layers with depth ``<= i`` from all layers with depth ``> i``.

``LayerGraph`` is framework-agnostic: CNN builders (models/cnn.py) and the LM
builders (models/transformer.py etc.) both lower to it, so the same
SEGM_COMP / SEGM_PROF / SEGM_BALANCED machinery applies to all architectures.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class LayerNode:
    """One layer (DAG node) with the costs the segmentation strategies use.

    params:            trainable parameter count (the paper's intrinsic balance
                       metric — 1 byte/param after int8 quantization).
    macs:              multiply-accumulate ops per single-input forward pass.
    out_bytes:         activation bytes produced per input (stage-to-stage
                       transfer cost when a cut lands right after this layer).
    weight_bytes:      storage bytes for the layer's weights.  Defaults to
                       ``params`` (int8) but LM archs use 2*params (bf16).
    """

    name: str
    params: int
    macs: int
    out_bytes: int = 0
    weight_bytes: Optional[int] = None
    kind: str = "generic"

    @property
    def bytes(self) -> int:
        return self.params if self.weight_bytes is None else self.weight_bytes


class LayerGraph:
    """Feed-forward DAG of :class:`LayerNode` with topological-depth utilities.

    Depth/level/per-depth aggregates are memoized after the first query and
    invalidated by :meth:`add` — the planner and the analytical device model
    query them thousands of times per plan search, so recomputing the
    topological order each call dominated plan-search wall time in profiles.
    Mutating ``_edges``/``_redges`` directly bypasses the invalidation and is
    unsupported after the first query.  ``cache=False`` restores the
    recompute-every-call behaviour (used by benchmarks/planner_bench.py to
    measure the uncached baseline).
    """

    def __init__(self, name: str = "model", cache: bool = True):
        self.name = name
        self.nodes: Dict[str, LayerNode] = {}
        self._edges: Dict[str, List[str]] = {}      # src -> [dst]
        self._redges: Dict[str, List[str]] = {}     # dst -> [src]
        self._order: List[str] = []                 # insertion order
        self._cache_enabled = cache
        self._cache: Dict[str, object] = {}

    def set_cache_enabled(self, enabled: bool) -> None:
        self._cache_enabled = enabled
        self._cache.clear()

    def _cached(self, key: str, compute):
        """Memoize `compute()` under `key`; results are shared — treat them
        as immutable."""
        if not self._cache_enabled:
            return compute()
        if key not in self._cache:
            self._cache[key] = compute()
        return self._cache[key]

    # -- construction -------------------------------------------------------
    def add(self, node: LayerNode, inputs: Sequence[str] = ()) -> str:
        if node.name in self.nodes:
            raise ValueError(f"duplicate layer name {node.name!r}")
        for src in inputs:
            if src not in self.nodes:
                raise ValueError(f"unknown input {src!r} for layer {node.name!r}")
        self._cache.clear()
        self.nodes[node.name] = node
        self._order.append(node.name)
        self._edges[node.name] = []
        self._redges[node.name] = list(inputs)
        for src in inputs:
            self._edges[src].append(node.name)
        return node.name

    def add_layer(self, name: str, params: int = 0, macs: int = 0,
                  out_bytes: int = 0, inputs: Sequence[str] = (),
                  weight_bytes: Optional[int] = None, kind: str = "generic") -> str:
        return self.add(
            LayerNode(name=name, params=params, macs=macs, out_bytes=out_bytes,
                      weight_bytes=weight_bytes, kind=kind),
            inputs,
        )

    # -- queries ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.nodes)

    def successors(self, name: str) -> List[str]:
        return self._edges[name]

    def predecessors(self, name: str) -> List[str]:
        return self._redges[name]

    def topological_order(self) -> List[str]:
        """Kahn's algorithm; raises on cycles (models must be feed-forward)."""
        return self._cached("topo", self._topological_order)

    def _topological_order(self) -> List[str]:
        indeg = {n: len(self._redges[n]) for n in self.nodes}
        # deterministic: seed queue in insertion order
        q = deque(n for n in self._order if indeg[n] == 0)
        out: List[str] = []
        while q:
            n = q.popleft()
            out.append(n)
            for m in self._edges[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    q.append(m)
        if len(out) != len(self.nodes):
            raise ValueError("layer graph has a cycle; feed-forward DAG required")
        return out

    def depths(self) -> Dict[str, int]:
        """Depth of each layer = max distance from any input (paper §6.1.1)."""
        return self._cached("depths", self._depths)

    def _depths(self) -> Dict[str, int]:
        depth: Dict[str, int] = {}
        for n in self.topological_order():
            preds = self._redges[n]
            depth[n] = 0 if not preds else 1 + max(depth[p] for p in preds)
        return depth

    @property
    def depth(self) -> int:
        """Total model depth d (number of depth levels)."""
        d = self.depths()
        return 1 + max(d.values()) if d else 0

    # -- per-depth aggregation (the P array of Algorithm 1) ------------------
    def levels(self) -> List[List[str]]:
        """Layer names grouped by depth, ascending."""
        return self._cached("levels", self._levels)

    def _levels(self) -> List[List[str]]:
        d = self.depths()
        levels: List[List[str]] = [[] for _ in range(self.depth)]
        for n in self._order:
            levels[d[n]].append(n)
        return levels

    def params_per_depth(self) -> List[int]:
        """P[i] = number of parameters at depth i (paper §6.1.2)."""
        return self._cached("params_per_depth", lambda: [
            sum(self.nodes[n].params for n in lvl) for lvl in self.levels()])

    def bytes_per_depth(self) -> List[int]:
        return self._cached("bytes_per_depth", lambda: [
            sum(self.nodes[n].bytes for n in lvl) for lvl in self.levels()])

    def macs_per_depth(self) -> List[int]:
        return self._cached("macs_per_depth", lambda: [
            sum(self.nodes[n].macs for n in lvl) for lvl in self.levels()])

    def out_bytes_per_depth(self) -> List[int]:
        """Activation bytes crossing a horizontal cut placed after each depth.

        For a cut after depth i, the transferred tensors are the outputs of
        every layer at depth <= i that feeds a layer at depth > i.
        """
        return self._cached("out_bytes_per_depth", self._out_bytes_per_depth)

    def _out_bytes_per_depth(self) -> List[int]:
        d = self.depths()
        out = [0] * self.depth
        for n in self._order:
            node = self.nodes[n]
            succs = self._edges[n]
            tgt_depths = [d[s] for s in succs]
            if not tgt_depths:
                continue
            hi = max(tgt_depths)
            # this node's output crosses every cut in [d[n], hi-1]
            for cut in range(d[n], hi):
                out[cut] += node.out_bytes
        return out

    # -- totals ---------------------------------------------------------------
    @property
    def total_params(self) -> int:
        return sum(n.params for n in self.nodes.values())

    @property
    def total_macs(self) -> int:
        return sum(n.macs for n in self.nodes.values())

    @property
    def total_bytes(self) -> int:
        return sum(n.bytes for n in self.nodes.values())

    def layers_in_depth_range(self, lo: int, hi: int) -> List[str]:
        """Layers whose depth is in [lo, hi] — i.e. one pipeline segment."""
        d = self.depths()
        return [n for n in self._order if lo <= d[n] <= hi]

    def summary(self) -> str:
        return (f"LayerGraph({self.name}: {len(self)} layers, depth {self.depth}, "
                f"{self.total_params/1e6:.1f}M params, {self.total_macs/1e6:.0f}M MACs)")


def chain_graph(name: str, sizes: Iterable[Tuple[str, int, int, int]]) -> LayerGraph:
    """Build a simple chain model: sizes = [(layer_name, params, macs, out_bytes)]."""
    g = LayerGraph(name)
    prev: Tuple[str, ...] = ()
    for lname, params, macs, out_b in sizes:
        g.add_layer(lname, params=params, macs=macs, out_bytes=out_b, inputs=prev)
        prev = (lname,)
    return g
