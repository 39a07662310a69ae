"""Functional graph-model framework for the CNN zoo, in PyTorch.

Ported from ``repro/models/layers.py``.  Every model is a
:class:`GraphModel`: a DAG of :class:`OpNode`, each with a parameter
initializer and a plain-PyTorch apply function.  From a GraphModel we
derive:

* a runnable forward pass (``init`` / ``apply``);
* partial execution of any layer subset (``apply_subset``) — what the
  pipelined executor runs per stage, with cut-crossing activations passed
  through the stage boundary exactly like the paper's host queues;
* a :class:`repro_torch.core.graph.LayerGraph` with per-layer
  params/MACs/activation bytes (``to_layer_graph``) — the input to the
  segmentation strategies.  ``params_count``, ``macs``, ``out_shape``,
  ``kind`` and ``act_dtype_bytes`` equal the reference's node for node, so
  the copied planner makes the same plans.

Layout: activations at node boundaries are NHWC ``(B, H, W, C)``, as in the
reference, so ``apply_subset`` boundary dicts line up with its.  A conv or
pool views its contiguous NHWC input as NCHW with ``permute(0, 3, 1, 2)``
(``channels_last`` strides, no copy), conv weights are OIHW held
``channels_last``, and the result's ``permute(0, 2, 3, 1)`` is contiguous
NHWC again.  The reference's numerics that torch does not give by default:

* ``padding="same"`` is XLA's SAME: a total pad of
  ``max((ceil(h/s) - 1) * s + k - h, 0)`` per spatial axis, ``total // 2``
  before and the rest after (asymmetric on strided convs; torch's
  ``padding='same'`` rejects stride > 1), applied with ``F.pad``;
* max pool SAME pads with -inf; avg pool divides the window sum by the
  count of unpadded cells (a pooled ones tensor, as the reference);
* depthwise conv is a grouped conv whose reference HWIO weight
  ``(kh, kw, 1, C * mult)`` is OIHW ``(C * mult, 1, kh, kw)``: output
  channel ``o`` reads input channel ``o // mult`` in both frameworks;
* BatchNorm follows inference semantics (running stats folded in) with
  eps 1e-3; parameter counts include the 4 per-channel BN tensors,
  matching Keras' "params" metric used by the paper's Table 1.

Parameters are a ``{node: {"w", "b", "gamma", ...}}`` dict of tensors; each
node's ``init`` draws from an explicit :class:`torch.Generator` on the
device it is given.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.graph import LayerGraph

Params = Dict[str, Any]
BN_EPS = 1e-3


@dataclasses.dataclass
class OpNode:
    name: str
    inputs: List[str]
    # (generator, device) -> params
    init: Callable[[torch.Generator, torch.device], Params]
    apply: Callable[[Params, List[torch.Tensor]], torch.Tensor]
    params_count: int
    macs: int
    out_shape: Tuple[int, ...]                   # per-single-input (no batch)
    kind: str = "generic"
    act_dtype_bytes: int = 1                     # int8 CNN path by default

    @property
    def out_bytes(self) -> int:
        return int(np.prod(self.out_shape)) * self.act_dtype_bytes


class GraphModel:
    """A DAG of OpNodes with one input placeholder and one output node."""

    def __init__(self, name: str, input_shape: Tuple[int, ...]):
        self.name = name
        self.input_shape = input_shape
        self.nodes: Dict[str, OpNode] = {}
        self._order: List[str] = []
        self.output: Optional[str] = None
        self._depths: Dict[str, int] = {}

    INPUT = "__input__"

    def depths(self) -> Dict[str, int]:
        """Depth of each node, as ``LayerGraph.depths`` counts it: 0 for a
        node that reads only the input, else 1 + its deepest input's."""
        if len(self._depths) != len(self._order):     # nodes were added
            depths: Dict[str, int] = {}
            for name in self._order:
                ins = [depths[i] for i in self.nodes[name].inputs
                       if i != self.INPUT]
                depths[name] = 1 + max(ins) if ins else 0
            self._depths = depths
        return self._depths

    def add(self, node: OpNode) -> str:
        if node.name in self.nodes or node.name == self.INPUT:
            raise ValueError(f"duplicate node {node.name}")
        for i in node.inputs:
            if i != self.INPUT and i not in self.nodes:
                raise ValueError(f"unknown input {i} of {node.name}")
        self.nodes[node.name] = node
        self._order.append(node.name)
        self.output = node.name
        return node.name

    def shape_of(self, name: str) -> Tuple[int, ...]:
        if name == self.INPUT:
            return self.input_shape
        return self.nodes[name].out_shape

    # -- parameters -----------------------------------------------------------
    def init(self, device="cuda",
             generator: Optional[torch.Generator] = None) -> Params:
        """Random fp32 parameters on ``device``, drawn node by node from
        ``generator`` (which must live on ``device``)."""
        device = torch.device(device)
        params: Params = {}
        for name in self._order:
            p = self.nodes[name].init(generator, device)
            if p:
                params[name] = p
        return params

    @property
    def total_params(self) -> int:
        return sum(n.params_count for n in self.nodes.values())

    @property
    def total_macs(self) -> int:
        return sum(n.macs for n in self.nodes.values())

    # -- execution --------------------------------------------------------------
    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) -> the output node's activation."""
        acts: Dict[str, torch.Tensor] = {self.INPUT: x}
        for name in self._order:
            node = self.nodes[name]
            xs = [acts[i] for i in node.inputs]
            acts[name] = node.apply(params.get(name, {}), xs)
        assert self.output is not None
        return acts[self.output]

    def apply_subset(self, params: Params,
                     boundary: Dict[str, torch.Tensor],
                     layer_names: Sequence[str]) -> Dict[str, torch.Tensor]:
        """Execute only `layer_names` (a contiguous depth range), reading
        cut-crossing inputs from `boundary`; returns activations needed by
        later layers (plus the model output if produced).  A boundary
        activation that a layer past the range still reads (a skip
        connection over the whole stage) is passed on too."""
        subset = set(layer_names)
        acts: Dict[str, torch.Tensor] = dict(boundary)
        for name in self._order:
            if name not in subset:
                continue
            node = self.nodes[name]
            xs = [acts[i] for i in node.inputs]
            acts[name] = node.apply(params.get(name, {}), xs)
        # outputs = activations consumed outside the subset, or final output
        depth = self.depths()
        last = max(depth[n] for n in subset)
        needed: Dict[str, torch.Tensor] = {}
        for name in self._order:
            if name in subset:
                continue
            for i in self.nodes[name].inputs:
                if i in subset or (i in boundary and depth[name] > last):
                    needed[i] = acts[i]
        if self.output in subset:
            needed[self.output] = acts[self.output]
        return needed

    # -- lowering to the segmentation representation ----------------------------
    def to_layer_graph(self) -> LayerGraph:
        g = LayerGraph(self.name)
        for name in self._order:
            node = self.nodes[name]
            inputs = [i for i in node.inputs if i != self.INPUT]
            g.add_layer(name, params=node.params_count, macs=node.macs,
                        out_bytes=node.out_bytes, inputs=inputs, kind=node.kind)
        return g


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial axis: (before, after)."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> an NCHW view (channels_last strides when x is
    contiguous NHWC)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Builder: tracks spatial shapes and emits OpNodes with cost annotations.
# ---------------------------------------------------------------------------
class Builder:
    """Convenience layer-emitter for CNN definitions (NHWC, single image)."""

    def __init__(self, name: str, input_hw: Tuple[int, int], channels: int = 3):
        h, w = input_hw
        self.model = GraphModel(name, (h, w, channels))
        self._n = 0

    def _uniq(self, prefix: str) -> str:
        self._n += 1
        return f"{prefix}_{self._n}"

    # ---- primitive ops -------------------------------------------------------
    def conv(self, x: str, filters: int, kernel: int | Tuple[int, int],
             stride: int = 1, padding: str = "same", use_bias: bool = True,
             name: Optional[str] = None, groups: int = 1) -> str:
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        in_shape = self.model.shape_of(x)
        h, w, cin = in_shape
        if cin % groups:
            raise ValueError("cin % groups != 0")
        if padding == "same":
            oh, ow = math.ceil(h / stride), math.ceil(w / stride)
            (pt, pb), (pl, pr) = same_pads(h, kh, stride), same_pads(w, kw,
                                                                      stride)
        else:
            oh, ow = (h - kh) // stride + 1, (w - kw) // stride + 1
            pt = pb = pl = pr = 0
        wshape = (kh, kw, cin // groups, filters)
        pcount = int(np.prod(wshape)) + (filters if use_bias else 0)
        macs = (cin // groups) * filters * kh * kw * oh * ow
        nm = name or self._uniq("conv")
        pads = (pl, pr, pt, pb)

        def init(gen: torch.Generator, device: torch.device) -> Params:
            fan_in = kh * kw * (cin // groups)
            wt = torch.randn((filters, cin // groups, kh, kw), generator=gen,
                             device=device) * (1.0 / math.sqrt(fan_in))
            p = {"w": wt.contiguous(memory_format=torch.channels_last)}
            if use_bias:
                p["b"] = torch.zeros(filters, device=device)
            return p

        def apply(p: Params, xs: List[torch.Tensor]) -> torch.Tensor:
            v = _nchw(xs[0])
            if any(pads):
                v = F.pad(v, pads)
            return _nhwc(F.conv2d(v, p["w"], p.get("b"), stride=stride,
                                  groups=groups))

        self.model.add(OpNode(nm, [x], init, apply, pcount, macs,
                              (oh, ow, filters), kind="conv"))
        return nm

    def dwconv(self, x: str, kernel: int, stride: int = 1,
               padding: str = "same", use_bias: bool = True,
               name: Optional[str] = None, multiplier: int = 1) -> str:
        in_shape = self.model.shape_of(x)
        _, _, cin = in_shape
        return self.conv(x, cin * multiplier, kernel, stride, padding,
                         use_bias, name or self._uniq("dwconv"), groups=cin)

    def bn(self, x: str, name: Optional[str] = None) -> str:
        h, w, c = self.model.shape_of(x)
        nm = name or self._uniq("bn")

        def init(gen: torch.Generator, device: torch.device) -> Params:
            return {"gamma": torch.ones(c, device=device),
                    "beta": torch.zeros(c, device=device),
                    "mean": torch.zeros(c, device=device),
                    "var": torch.ones(c, device=device)}

        def apply(p: Params, xs: List[torch.Tensor]) -> torch.Tensor:
            inv = torch.rsqrt(p["var"] + BN_EPS)
            return (xs[0] - p["mean"]) * inv * p["gamma"] + p["beta"]

        # Keras counts all 4 BN tensors in "params" (2 trainable + 2 stats)
        self.model.add(OpNode(nm, [x], init, apply, 4 * c, 0, (h, w, c),
                              kind="bn"))
        return nm

    def act(self, x: str, fn: str = "relu", name: Optional[str] = None) -> str:
        shape = self.model.shape_of(x)
        nm = name or self._uniq(fn)
        f = {"relu": torch.relu,
             "relu6": lambda v: torch.clamp(v, 0, 6),
             "swish": F.silu,
             "sigmoid": torch.sigmoid}[fn]

        def apply(p: Params, xs: List[torch.Tensor]) -> torch.Tensor:
            return f(xs[0])

        self.model.add(OpNode(nm, [x], _no_params, apply, 0, 0, shape,
                              kind="act"))
        return nm

    def pool(self, x: str, kind: str, size: int, stride: int,
             padding: str = "same", name: Optional[str] = None) -> str:
        h, w, c = self.model.shape_of(x)
        if padding == "same":
            oh, ow = math.ceil(h / stride), math.ceil(w / stride)
            (pt, pb), (pl, pr) = (same_pads(h, size, stride),
                                  same_pads(w, size, stride))
        else:
            oh, ow = (h - size) // stride + 1, (w - size) // stride + 1
            pt = pb = pl = pr = 0
        nm = name or self._uniq(f"{kind}pool")
        pads = (pl, pr, pt, pb)

        def apply(p: Params, xs: List[torch.Tensor]) -> torch.Tensor:
            v = _nchw(xs[0])
            if kind == "max":
                if any(pads):
                    v = F.pad(v, pads, value=-math.inf)
                return _nhwc(F.max_pool2d(v, size, stride))
            # window sum over zero padding / count of the unpadded cells
            ones = torch.ones((1, 1, h, w), dtype=v.dtype, device=v.device)
            if any(pads):
                v, ones = F.pad(v, pads), F.pad(ones, pads)
            s = F.avg_pool2d(v, size, stride, divisor_override=1)
            cnt = F.avg_pool2d(ones, size, stride, divisor_override=1)
            return _nhwc(s / cnt)

        self.model.add(OpNode(nm, [x], _no_params, apply, 0, 0,
                              (oh, ow, c), kind="pool"))
        return nm

    def gap(self, x: str, name: Optional[str] = None) -> str:
        _, _, c = self.model.shape_of(x)
        nm = name or self._uniq("gap")

        def apply(p: Params, xs: List[torch.Tensor]) -> torch.Tensor:
            return torch.mean(xs[0], dim=(1, 2))

        self.model.add(OpNode(nm, [x], _no_params, apply, 0, 0, (c,),
                              kind="pool"))
        return nm

    def dense(self, x: str, units: int, use_bias: bool = True,
              name: Optional[str] = None) -> str:
        shape = self.model.shape_of(x)
        fin = int(np.prod(shape))
        nm = name or self._uniq("dense")
        pcount = fin * units + (units if use_bias else 0)

        def init(gen: torch.Generator, device: torch.device) -> Params:
            p = {"w": torch.randn((fin, units), generator=gen, device=device)
                      * (1.0 / math.sqrt(fin))}
            if use_bias:
                p["b"] = torch.zeros(units, device=device)
            return p

        def apply(p: Params, xs: List[torch.Tensor]) -> torch.Tensor:
            v = xs[0].reshape(xs[0].shape[0], -1)      # NHWC order
            y = v @ p["w"]
            return y + p["b"] if use_bias else y

        self.model.add(OpNode(nm, [x], init, apply, pcount, fin * units,
                              (units,), kind="dense"))
        return nm

    def add(self, xs: Sequence[str], name: Optional[str] = None) -> str:
        shape = self.model.shape_of(xs[0])
        nm = name or self._uniq("add")

        def apply(p: Params, vs: List[torch.Tensor]) -> torch.Tensor:
            out = vs[0]
            for v in vs[1:]:
                out = out + v
            return out

        self.model.add(OpNode(nm, list(xs), _no_params, apply, 0, 0, shape,
                              kind="add"))
        return nm

    def concat(self, xs: Sequence[str], name: Optional[str] = None) -> str:
        shapes = [self.model.shape_of(x) for x in xs]
        h, w = shapes[0][0], shapes[0][1]
        c = sum(s[2] for s in shapes)
        nm = name or self._uniq("concat")

        def apply(p: Params, vs: List[torch.Tensor]) -> torch.Tensor:
            return torch.cat(vs, dim=-1)

        self.model.add(OpNode(nm, list(xs), _no_params, apply, 0, 0,
                              (h, w, c), kind="concat"))
        return nm

    # ---- compound blocks ------------------------------------------------------
    def conv_bn(self, x: str, filters: int, kernel, stride: int = 1,
                padding: str = "same", act: Optional[str] = "relu",
                prefix: Optional[str] = None) -> str:
        p = prefix or self._uniq("cb")
        y = self.conv(x, filters, kernel, stride, padding, use_bias=False,
                      name=f"{p}_conv")
        y = self.bn(y, name=f"{p}_bn")
        if act:
            y = self.act(y, act, name=f"{p}_{act}")
        return y

    def build(self) -> GraphModel:
        return self.model


def _no_params(gen: torch.Generator, device: torch.device) -> Params:
    return {}
