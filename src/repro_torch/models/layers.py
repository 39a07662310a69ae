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
  ``padding='same'`` rejects stride > 1), applied with ``F.pad``, except
  where a depthwise conv's kernel takes them as offsets (below);
* max pool SAME pads with -inf; avg pool divides the window sum by the
  count of unpadded cells (a pooled ones tensor, as the reference);
* depthwise conv is a grouped conv whose reference HWIO weight
  ``(kh, kw, 1, C * mult)`` is OIHW ``(C * mult, 1, kh, kw)``: output
  channel ``o`` reads input channel ``o // mult`` in both frameworks;
* BatchNorm follows inference semantics (running stats folded in) with
  eps 1e-3; parameter counts include the 4 per-channel BN tensors,
  matching Keras' "params" metric used by the paper's Table 1.

Execution runs a program computed once per (layer subset, boundary names)
and cached on the model (:meth:`GraphModel.program`): the nodes in order,
each ``bn`` node run together with the ``add`` and ``act`` nodes that
follow it as one :class:`FusedGroup`, a call of
:func:`~repro_torch.kernels.bn_epilogue.bn_epilogue` (one CUDA launch on
the card, the same plain ops on the CPU, equal bit for bit).  A group is a
``bn``, then optionally an ``add`` of one other tensor that reads it, then
optionally a ``relu`` or ``relu6`` ``act`` that reads the node before; it
takes in a node only where the node before has it as its only consumer,
it lies in the subset, and the node before is not among the tensors the
subset returns.  A group without an ``add`` whose ``bn`` reads a depthwise
convolution takes the convolution in too, under the same rules (the
``bn`` its only consumer, in the subset, not returned): the group is then
one :func:`~repro_torch.kernels.dwconv.dwconv` call with the BN and the
activation in the kernel's epilogue, and no ``bn_epilogue`` launch.  So a
stage cut inside a group hands over the unfused tensor, and a profile
that times one depth level at a time fuses nothing.  A group runs at its
last node's place in the order.  Where autograd records through one of
its inputs or parameters, a group runs the nodes' plain ops
(:func:`~repro_torch.kernels.ref.bn_epilogue_ref`,
:func:`~repro_torch.kernels.ref.dwconv_ref`): the kernels have no
backward.  On the card a group raises for an activation the kernel does
not take (not fp32, not contiguous), so a change of the forward's layout
or dtype cannot take it off the kernel unseen.  Node names, kinds, costs
and ``to_layer_graph`` do not see the groups.

A depthwise convolution (``groups`` = input = output channels; its node
records its stride and pads in ``OpNode.depthwise``) is one call of
:func:`~repro_torch.kernels.dwconv.dwconv`, which takes the SAME pads as
offsets and makes no padded tensor (one CUDA launch on the card; on the
CPU the ``F.pad`` and grouped ``F.conv2d`` above; where autograd records
through its input or weight, those plain ops on any device: the kernel has
no backward), with the BN and activation after it where its group takes
it in.  Another grouped convolution (none in the zoo) keeps the ``F.pad``
and ``conv2d`` route.  Either runs inside the profiler span
:data:`DWCONV_SPAN` (nothing without a profiler), which the benchmark's
depthwise metrics read, the BN and activation of a depthwise conv's group
with it; the route and the span are chosen when the node is built, and an
ungrouped convolution opens none.

Parameters are a ``{node: {"w", "b", "gamma", ...}}`` dict of tensors; each
node's ``init`` draws from an explicit :class:`torch.Generator` on the
device it is given.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Any, Callable, Dict, FrozenSet, List, NamedTuple,
                    Optional, Sequence, Tuple)

import numpy as np
import torch
import torch.nn.functional as F

from ..core.graph import LayerGraph
from ..kernels.bn_epilogue import bn_epilogue
from ..kernels.dwconv import dwconv
from ..kernels.ref import EPILOGUE_ACTS, bn_epilogue_ref, dwconv_ref
from ..profiling.spans import span

Params = Dict[str, Any]
DWCONV_SPAN = "cnn.dwconv"


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
    activation: Optional[str] = None             # an act node's function
    # a depthwise conv's (stride, pads in F.pad's order)
    depthwise: Optional[Tuple[int, Tuple[int, int, int, int]]] = None

    @property
    def out_bytes(self) -> int:
        return int(np.prod(self.out_shape)) * self.act_dtype_bytes


@dataclasses.dataclass(frozen=True)
class FusedGroup:
    """A ``bn`` node and the ``add`` (with its other input, ``residual``)
    and ``act`` (of function ``fn``) nodes after it that run with it as
    one ``bn_epilogue`` call; or, with ``conv``, the depthwise conv the
    ``bn`` reads, the ``bn`` and the ``act`` as one ``dwconv`` call."""
    bn: str
    add: Optional[str] = None
    residual: Optional[str] = None
    act: Optional[str] = None
    fn: Optional[str] = None
    conv: Optional[str] = None

    @property
    def nodes(self) -> Tuple[str, ...]:
        return tuple(n for n in (self.conv, self.bn, self.add, self.act)
                     if n)

    @property
    def out(self) -> str:
        return self.nodes[-1]


# one step of a program: (output name, fn(*params, inputs), input names,
# the nodes whose params fn takes, one Params each)
Step = Tuple[str, Callable[..., torch.Tensor], Tuple[str, ...],
             Tuple[str, ...]]


class Program(NamedTuple):
    """What :meth:`GraphModel.apply_subset` runs for one (layer subset,
    boundary names): the steps in order, the fused groups among them, and
    the names of the activations it returns."""
    steps: Tuple[Step, ...]
    groups: Tuple[FusedGroup, ...]
    returns: Tuple[str, ...]


def _epilogue_step(act: Optional[str], residual: bool):
    """A group's step: one ``bn_epilogue`` call, or the nodes' plain ops
    where autograd records through an input or a parameter (the kernel
    has no backward; on the CPU both are the same ops)."""
    def run(p: Params, xs: List[torch.Tensor]) -> torch.Tensor:
        args = (xs[0], p["mean"], p["var"], p["gamma"], p["beta"],
                xs[1] if residual else None)
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in args):
            return bn_epilogue_ref(*args, act)
        return bn_epilogue(*args, act)
    return run


def _depthwise(x: torch.Tensor, p: Params, stride: int,
               pads: Tuple[int, int, int, int],
               bn: Optional[Tuple[torch.Tensor, ...]] = None,
               act: Optional[str] = None) -> torch.Tensor:
    """A depthwise conv of params ``p``, and the BN (``bn``: mean, var,
    gamma, beta) and ``act`` after it where given, inside
    :data:`DWCONV_SPAN`: one ``dwconv`` call, or its plain ops where
    autograd records through an input or a parameter (the kernel has no
    backward; on the CPU both are the same ops)."""
    args = (x, p["w"], p.get("b"), stride, pads, bn, act)
    with span(DWCONV_SPAN):
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (*args[:3], *(bn or ()))):
            return dwconv_ref(*args)
        return dwconv(*args)


def _dwconv_step(stride: int, pads: Tuple[int, int, int, int],
                 act: Optional[str]):
    """A group's step with a depthwise conv: fn(conv's params, bn's
    params, [x])."""
    def run(pc: Params, pb: Params, xs: List[torch.Tensor]) -> torch.Tensor:
        return _depthwise(xs[0], pc, stride, pads,
                          (pb["mean"], pb["var"], pb["gamma"], pb["beta"]),
                          act)
    return run


class GraphModel:
    """A DAG of OpNodes with one input placeholder and one output node."""

    def __init__(self, name: str, input_shape: Tuple[int, ...]):
        self.name = name
        self.input_shape = input_shape
        self.nodes: Dict[str, OpNode] = {}
        self._order: List[str] = []
        self.output: Optional[str] = None
        self._depths: Dict[str, int] = {}
        self._programs: Dict[Tuple[Optional[Tuple[str, ...]],
                                   FrozenSet[str]], Program] = {}

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
        self._programs.clear()
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
        acts = self._run(self.program(), params, {self.INPUT: x})
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
        prog = self.program(layer_names, boundary)
        acts = self._run(prog, params, dict(boundary))
        return {name: acts[name] for name in prog.returns}

    def _run(self, prog: Program, params: Params,
             acts: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        for out, fn, inputs, owners in prog.steps:
            acts[out] = fn(*[params.get(o, {}) for o in owners],
                           [acts[i] for i in inputs])
        return acts

    def program(self, layer_names: Optional[Sequence[str]] = None,
                boundary: Sequence[str] = (INPUT,)) -> Program:
        """The program of ``layer_names`` (None: every node) fed the
        ``boundary`` names, built on first use and cached."""
        key = (None if layer_names is None else tuple(layer_names),
               frozenset(boundary))
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = self._build_program(*key)
        return prog

    def _build_program(self, layer_names: Optional[Tuple[str, ...]],
                       boundary: FrozenSet[str]) -> Program:
        subset = set(self._order if layer_names is None else layer_names)
        # outputs = activations consumed outside the subset, or final output
        depth = self.depths()
        last = max(depth[n] for n in subset)
        returns: Dict[str, None] = {}
        consumers: Dict[str, List[str]] = {}
        for name in self._order:
            for i in self.nodes[name].inputs:
                consumers.setdefault(i, []).append(name)
                if name not in subset and (
                        i in subset or (i in boundary and depth[name] > last)):
                    returns[i] = None
        if self.output in subset:
            returns[self.output] = None

        def next_of(name: str) -> Optional[OpNode]:
            """The node a group may take in after ``name``."""
            after = consumers.get(name, [])
            if len(after) == 1 and after[0] in subset and name not in returns:
                return self.nodes[after[0]]
            return None

        group_of: Dict[str, FusedGroup] = {}
        for name in self._order:
            if name not in subset or self.nodes[name].kind != "bn":
                continue
            add = residual = act = fn = None
            nxt = next_of(name)
            if (nxt is not None and nxt.kind == "add"
                    and len(nxt.inputs) == 2 and nxt.name not in group_of):
                other = (nxt.inputs[1] if nxt.inputs[0] == name
                         else nxt.inputs[0])
                if (other != name
                        and self.shape_of(other) == self.shape_of(name)):
                    add, residual = nxt.name, other
                    nxt = next_of(add)
            if (nxt is not None and nxt.kind == "act"
                    and nxt.activation in EPILOGUE_ACTS):
                act, fn = nxt.name, nxt.activation
            conv = self.nodes[name].inputs[0]
            if not (add is None and conv in subset
                    and self.nodes[conv].depthwise is not None
                    and next_of(conv) is self.nodes[name]):
                conv = None
            group = FusedGroup(name, add, residual, act, fn, conv)
            for n in group.nodes:
                group_of[n] = group

        steps: List[Step] = []
        for name in self._order:
            if name not in subset:
                continue
            group = group_of.get(name)
            if group is None:
                node = self.nodes[name]
                steps.append((name, node.apply, tuple(node.inputs), (name,)))
            elif name == group.out and group.conv:
                conv = self.nodes[group.conv]
                steps.append((name, _dwconv_step(*conv.depthwise, group.fn),
                              (conv.inputs[0],), (group.conv, group.bn)))
            elif name == group.out:
                inputs = (self.nodes[group.bn].inputs[0],) + (
                    (group.residual,) if group.residual else ())
                steps.append((name, _epilogue_step(
                    group.fn, group.residual is not None), inputs,
                    (group.bn,)))
        groups = tuple(dict.fromkeys(group_of.values()))
        return Program(tuple(steps), groups, tuple(returns))

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

        depthwise = None
        if groups > 1 and groups == cin == filters:
            # depthwise, multiplier 1: the kernel pads as it reads
            depthwise = (stride, pads)

            def apply(p: Params, xs: List[torch.Tensor]) -> torch.Tensor:
                return _depthwise(xs[0], p, stride, pads)
        elif groups > 1:
            conv = apply

            def apply(p: Params, xs: List[torch.Tensor]) -> torch.Tensor:
                with span(DWCONV_SPAN):
                    return conv(p, xs)

        self.model.add(OpNode(nm, [x], init, apply, pcount, macs,
                              (oh, ow, filters), kind="conv",
                              depthwise=depthwise))
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
            return bn_epilogue_ref(xs[0], p["mean"], p["var"], p["gamma"],
                                   p["beta"])

        # Keras counts all 4 BN tensors in "params" (2 trainable + 2 stats)
        self.model.add(OpNode(nm, [x], init, apply, 4 * c, 0, (h, w, c),
                              kind="bn"))
        return nm

    def act(self, x: str, fn: str = "relu", name: Optional[str] = None) -> str:
        shape = self.model.shape_of(x)
        nm = name or self._uniq(fn)
        f = {**EPILOGUE_ACTS, "swish": F.silu, "sigmoid": torch.sigmoid}[fn]

        def apply(p: Params, xs: List[torch.Tensor]) -> torch.Tensor:
            return f(xs[0])

        self.model.add(OpNode(nm, [x], _no_params, apply, 0, 0, shape,
                              kind="act", activation=fn))
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
