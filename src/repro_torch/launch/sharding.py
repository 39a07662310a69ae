"""The dry-run's partition rules, as ``repro/launch/sharding.py``'s, on a
card :class:`~repro_torch.launch.mesh.Grid`.

A leaf's spec is a tuple with one entry per dimension: None, an axis name,
or a tuple of axis names (the pod and data axes together), as the entries
of the reference's ``PartitionSpec``.  Nothing is placed: the specs only
say how many devices share a leaf, which the dry-run's per-device state
bytes read.  The rules are the reference's, name-keyed with divisibility
fallbacks:

* column-parallel (output-feature sharded): wq/wk/wv/wu/wg (+ their biases)
* row-parallel (input-feature sharded):     wo/wd
* expert-parallel: MoE expert tensors shard the leading expert axis
* vocab-parallel: embed/head shard the vocab axis when divisible, else
  d_model, else nothing
* ``fsdp`` (the train step's, the reference's ``fsdp="blocks"``): the
  per-layer tensors also shard their first free divisible dimension over
  the data axes; AdamW's moments always do (ZeRO-1)
* KV caches shard batch over (pod, data) and head_dim (``mode="hd"``) or
  the sequence (``mode="seq"``) over model; recurrent states their
  channel/head dims.

The reference stacks repeated layers along a leading axis that no rule
shards; the port keeps them as per-layer lists (``blocks``, ``super``,
``tail``, ``enc``, ``dec``; rwkv6's and recurrentgemma's cache states), so
a leaf under one is the stacked leaf with its layer axis removed.  The
reference's batch rule is not needed by the record and not ported.
"""
from __future__ import annotations

import math
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from .mesh import Grid, data_axes, model_axis_size

Spec = Tuple[Any, ...]

# param-name -> role
_COL = {"wq", "wk", "wv", "wu", "wg", "wr", "wx", "wgate", "maa_w1",
        "w_lora1"}
_ROW = {"wo", "wd", "w_lora2"}
_COL_BIAS = {"bq", "bk", "bv", "bu"}
_STACK_KEYS = {"blocks", "super", "tail", "enc", "dec"}


class Placed(NamedTuple):
    path: Tuple[Any, ...]      # dict keys and list indices down to the leaf
    leaf: torch.Tensor
    spec: Spec


def _walk(tree: Any, path: Tuple[Any, ...] = (),
          layers: Optional[int] = None):
    """(path, leaf, layers) of each tensor leaf; ``layers``: the length of
    the per-layer list the leaf is under, else None."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _walk(sub, path + (key,), layers)
    elif isinstance(tree, list):
        for i, sub in enumerate(tree):
            yield from _walk(sub, path + (i,), len(tree))
    else:
        yield path, tree, layers


def _names(path) -> Tuple[str, ...]:
    return tuple(p for p in path if isinstance(p, str))


def _data_spec(grid: Grid):
    daxes = data_axes(grid)
    return (daxes if len(daxes) > 1 else (daxes[0] if daxes else None),
            math.prod(grid.shape[a] for a in daxes))


def spec_for_param(names: Tuple[str, ...], shape: Tuple[int, ...],
                   msize: int, has_model: bool) -> Spec:
    """The reference's ``_spec_for_param`` on a leaf without a layer
    axis."""
    nd = len(shape)
    name = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""
    none = (None,) * nd

    def spec(axis: int) -> Spec:
        return tuple("model" if i == axis else None for i in range(nd))

    if not has_model or msize <= 1:
        return none

    def ok(axis: int) -> bool:
        return 0 <= axis < nd and shape[axis] % msize == 0

    # MoE expert tensors: (E, D, F) -> shard E
    if parent == "mlp" and name in ("wg", "wu", "wd") and nd == 3:
        return spec(0) if ok(0) else none
    if name == "router":
        return none
    if name in ("embed", "head"):
        # embed (V, D): vocab, else d_model; head (D, V): vocab, else D
        first, second = (nd - 2, nd - 1) if name == "embed" else (nd - 1,
                                                                  nd - 2)
        return (spec(first) if ok(first)
                else spec(second) if ok(second) else none)
    if name in _COL and nd >= 2:
        return spec(nd - 1) if ok(nd - 1) else none
    if name in _ROW and nd >= 2:
        return spec(nd - 2) if ok(nd - 2) else none
    if name in _COL_BIAS:
        return spec(nd - 1) if ok(nd - 1) else none
    if name in ("conv_w", "conv_b", "a_gate_w", "a_gate_b", "i_gate_w",
                "i_gate_b", "lam"):         # rglru channel vectors
        return spec(nd - 1) if ok(nd - 1) else none
    return none                             # norms, scalars, small adapters


def _shard_first_free(spec: Spec, shape, dspec, dsize: int) -> Spec:
    """``spec`` with the data axes on its first unsharded dimension that
    ``dsize`` divides (the layer axis, the reference's first, is gone)."""
    dims = list(spec)
    for ax, n in enumerate(shape):
        if dims[ax] is None and n % dsize == 0:
            dims[ax] = dspec
            break
    return tuple(dims)


def param_specs(grid: Grid, params: Any, fsdp: bool = False) -> List[Placed]:
    """Each parameter with its spec: the tensor-parallel rules, and with
    ``fsdp`` a per-layer tensor's first free divisible dimension over the
    data axes."""
    msize, has_model = model_axis_size(grid), "model" in grid.axis_names
    dspec, dsize = _data_spec(grid)
    out = []
    for path, leaf, _ in _walk(params):
        names = _names(path)
        sp = spec_for_param(names, tuple(leaf.shape), msize, has_model)
        stacked = any(n in _STACK_KEYS for n in names)
        if fsdp and stacked and dsize > 1:
            sp = _shard_first_free(sp, leaf.shape, dspec, dsize)
        out.append(Placed(path, leaf, sp))
    return out


def opt_state_specs(grid: Grid, opt_state: Any) -> List[Placed]:
    """ZeRO-1: each moment follows its parameter's rules plus the data
    axes on its first free divisible dimension; the step is replicated."""
    msize, has_model = model_axis_size(grid), "model" in grid.axis_names
    dspec, dsize = _data_spec(grid)
    out = []
    for path, leaf, _ in _walk(opt_state):
        names = _names(path)
        if names and names[-1] == "step":
            out.append(Placed(path, leaf, (None,) * leaf.dim()))
            continue
        sp = spec_for_param(names, tuple(leaf.shape), msize, has_model)
        if dsize > 1:
            sp = _shard_first_free(sp, leaf.shape, dspec, dsize)
        out.append(Placed(path, leaf, sp))
    return out


def cache_specs(grid: Grid, cache: Any, mode: str = "hd") -> List[Placed]:
    """Caches: batch over the data axes (a stacked leaf's axis 1, else its
    layer axis 0, where divisible), then per ``mode``: ``hd`` shards the
    last axis (head_dim / channels) over model, ``seq`` a K/V cache's
    sequence axis; recurrent states keep ``hd``'s rule in both modes.  A
    per-layer list's leaf is ruled as its stacked leaf; raises where that
    would shard the layer axis, which a list cannot show."""
    msize = model_axis_size(grid)
    dspec, dsize = _data_spec(grid)
    out = []
    for path, leaf, layers in _walk(cache):
        names = _names(path)
        shape = tuple(leaf.shape) if layers is None else (
            (layers,) + tuple(leaf.shape))
        nd = len(shape)
        dims: list = [None] * nd
        if names[-1] != "len":
            if dsize > 1:
                for ax in (1, 0):
                    if ax < nd and shape[ax] % dsize == 0:
                        dims[ax] = dspec
                        break
            is_kv = names[-1] in ("k", "v", "mem_k", "mem_v")
            if (mode == "seq" and is_kv and nd == 5 and msize > 1
                    and shape[2] % msize == 0):
                dims[2] = "model"           # sequence axis
            elif msize > 1 and nd >= 2 and shape[-1] % msize == 0:
                dims[-1] = "model"          # head_dim / channels
        if layers is not None:
            if dims[0] is not None:
                raise ValueError(f"{'.'.join(map(str, path))}: the rules "
                                 f"shard the layer axis of a per-layer list")
            dims = dims[1:]
        out.append(Placed(path, leaf, tuple(dims)))
    return out

