"""SPMD pipeline execution: lower a PlacementPlan onto the stages of a mesh
of cards.

The port of ``repro/launch/pipeline_spmd.py``.  The reference lowers any
unreplicated :class:`~repro_torch.core.placement.PlacementPlan` onto a
mesh axis, one stage per mesh slice, with ``ppermute`` hops inside
``shard_map``.  Here a :class:`StageMesh` gives each stage a device and,
on a card, a ``torch.cuda.Stream`` of that device:
``default_stage_mesh(S, cards=k)`` puts the stages in contiguous groups on
``k`` cards (stage ``s`` on ``cuda:(s * k // S)``, as the reference puts
stage ``s`` on device ``s`` when ``k = S``); ``cards=1`` keeps every stage
on the one card, a stream each.  On the CPU the stages run in order, with
no streams.

* **CNN GraphModels** -- each stage's layer range runs through
  ``GraphModel.apply_subset``; the tensors crossing each cut (a skip
  connection included: a tensor made in stage 0 and read in stage 3 rides
  through the stages between) are packed into one ``(microbatch, FLAT)``
  fp32 buffer, so every stage has one signature.
* **LM block families** (dense, moe) -- contiguous block ranges per
  stage, each stage looping over exactly its own blocks (no padding
  slots, so uneven counts cost nothing).

GPipe circular schedule, M microbatches over S stages::

    t = 0 .. M+S-2:
      stage s works on microbatch t - s (when 0 <= t - s < M)
      its stream first waits on the event stage s-1 recorded at step t-1
      stage S-1 writes microbatch t-S+1 into the output buffer

The host issues the whole schedule, then synchronizes once, on the last
stage's stream.  :func:`_hop` hands a stage's output to the next stage:
on one card the reader's stream waits on the writer's event and the
buffer is handed on with ``record_stream``, so the caching allocator does
not reuse it while the reader may still run; across cards the reader's
stream waits on the writer's event and copies the buffer into one of its
own card (over NVLink where the cards have peer access, else through the
host).  The output is the last stage's ``(M, mb, ...)`` buffer on the last
stage's device: there is no per-stage output to index.

**Weight streaming** (:func:`stream_stage_weights`): each stage's
weights are copied from pinned host memory to its card on that card's copy
stream, in stage order; the cards' copies run at once, each over its own
link.  With ``overlap=True`` every copy is in flight while ``compile_fn``
-- the bring-up that needs only shapes: loading the kernel libraries the
lowering launches and reserving the schedule's buffers in the caching
allocator of each card -- runs on the host; with ``overlap=False`` each
stage's copies land before the next stage's are issued and ``compile_fn``
runs after the last.  :class:`StreamReport` keeps the wall fill apart from
``blocked_s``, the host's time in event waits on the copies, over all
cards.  Host-to-device copies on the card have copy engines of their own,
so unlike the reference's CPU-emulated mesh the wall fill may shrink too.

**Numerics of the LM executor** (the reference's, not a choice of the
port): :meth:`SpmdPipelineExecutor.for_lm` runs the blocks on fp32
activations, with the model's bf16 weights made fp32 on each card after
the fill (the reference casts the embedded activations to float32 and
jnp promotes every bf16 weight); :func:`pipeline_logits` runs in the
model's dtype.

**Spans** (:func:`~repro_torch.profiling.spans.span`, nothing without a
profiler): :data:`CALL_SPAN` around a call of the executor,
``stage_spans(S)[s]`` around stage ``s``'s work on one microbatch in the
schedule (the hop into it, the stage, and for the last stage the copy
into the output buffer), :data:`BOUNDARY_SPAN` around each boundary
unpack and pack of a CNN stage and the call's input pack and output
unpack.  The benchmark's per-layer metrics read them from its trace.

Replicated-stage plans belong to the host executor:
:func:`_require_unreplicated` fails fast for direct low-level calls, and
the front door (``Deployment.executor``) downgrades that to a logged
fallback onto :class:`~repro_torch.core.pipeline.PipelineExecutor`.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint.store import tree_flatten, tree_map, tree_unflatten
from ..core.placement import PlacementPlan
from ..kernels import _build
from ..models import lm
from ..models.layers import GraphModel
from ..profiling.spans import span
from .serve import stage_block_counts

Params = Any
Specs = List[Tuple[str, Tuple[int, ...]]]

CALL_SPAN = "spmd.call"
BOUNDARY_SPAN = "spmd.boundary"
STAGE_SPAN = "spmd.stage."


@functools.lru_cache(maxsize=None)
def stage_spans(n_stages: int) -> Tuple[str, ...]:
    """The span names of the stages of an ``n_stages``-stage schedule:
    ``spmd.stage.<s>``, made once a stage count."""
    return tuple(f"{STAGE_SPAN}{s}" for s in range(n_stages))


# ---------------------------------------------------------------------------
# plan-side helpers
# ---------------------------------------------------------------------------
def plan_supports_spmd(plan: PlacementPlan) -> bool:
    """One stage == one stream: replicated stages need the host
    executor's round-robin fan-out."""
    reps = getattr(plan, "replica_counts", None)
    return not (reps and any(r != 1 for r in reps))


def _require_unreplicated(plan: PlacementPlan) -> None:
    """Hard error for direct low-level calls; the ``Deployment.executor``
    front door checks :func:`plan_supports_spmd` first and falls back to
    the host executor with a logged notice instead of reaching this."""
    if not plan_supports_spmd(plan):
        raise NotImplementedError(
            f"SPMD pipeline does not support replicated stages "
            f"(replica_counts={plan.replica_counts}); use the host "
            f"PipelineExecutor or re-plan with replicate=False")


# ---------------------------------------------------------------------------
# the stage mesh
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StageMesh:
    """The pipeline's stages on their devices: stage ``s`` runs on
    ``devices[s]``, on a CUDA stream of its own on a card (none on the CPU
    or ``meta``: the stages then run in order), and ``copy_streams[s]`` is
    the stream that copies weights onto that stage's card (one per card,
    shared by the card's stages, and one for every fill, so that a fill
    reuses the device memory the caching allocator keeps from the last)."""
    devices: Tuple[torch.device, ...]
    streams: Tuple[Optional[torch.cuda.Stream], ...]
    copy_streams: Tuple[Optional[torch.cuda.Stream], ...]

    def __post_init__(self):
        if not len(self.devices) == len(self.streams) == len(
                self.copy_streams):
            raise ValueError(f"{len(self.devices)} devices, "
                             f"{len(self.streams)} streams and "
                             f"{len(self.copy_streams)} copy streams")

    @property
    def n_stages(self) -> int:
        return len(self.devices)

    @property
    def on_card(self) -> bool:
        return any(d.type == "cuda" for d in self.devices)

    @property
    def cards(self) -> Tuple[torch.device, ...]:
        """The distinct devices of the mesh, in stage order."""
        return tuple(dict.fromkeys(self.devices))


def stage_cards(n_stages: int, cards: int) -> List[int]:
    """The card of each stage when ``n_stages`` stages go onto ``cards``
    cards in contiguous groups: stage ``s`` on card ``s * cards //
    n_stages`` (every card at least one stage; one stage a card when they
    are equal, as the reference's mesh)."""
    if not 1 <= cards <= n_stages:
        raise ValueError(f"{cards} cards for {n_stages} stages: every card "
                         f"needs at least one stage")
    return [s * cards // n_stages for s in range(n_stages)]


def default_stage_mesh(n_stages: int, device="cuda",
                       cards: Optional[int] = None) -> StageMesh:
    """``n_stages`` stages, each with its own stream on a card.

    * ``cards=None`` or ``1`` -- every stage on ``device``: the stages
      share the card and overlap through their streams.
    * ``cards=k`` -- the stages in contiguous groups on ``cuda:0`` ..
      ``cuda:k-1`` (:func:`stage_cards`), each card with its stages'
      streams and a weight copy stream of its own.  Raises, as the
      reference's mesh does, when this process sees fewer than ``k``
      cards, and when ``k > n_stages``: a mesh is never folded onto fewer
      cards than asked.

    Raises for a CUDA device when there is no card, and for ``cards``
    other than 1 on the CPU."""
    dev = resolve_device(device)
    k = 1 if cards is None else int(cards)
    if dev.type != "cuda":
        if k != 1:
            raise ValueError(f"cards={cards} needs CUDA devices; on "
                             f"{str(dev)!r} the stages run in order on "
                             f"the one device")
        return StageMesh((dev,) * n_stages, (None,) * n_stages,
                         (None,) * n_stages)
    if k == 1:
        # an index, so that a hop can tell its card from another
        devices = (torch.device("cuda", torch.cuda.current_device()
                                if dev.index is None else dev.index),
                   ) * n_stages
    else:
        if dev.index not in (None, 0):
            raise ValueError(f"a mesh of {k} cards starts at cuda:0, not "
                             f"{dev}")
        visible = torch.cuda.device_count()
        if visible < k:
            raise ValueError(f"SPMD pipeline over {k} cards needs >= {k} "
                             f"CUDA devices; this process sees {visible}")
        devices = tuple(torch.device("cuda", c)
                        for c in stage_cards(n_stages, k))
    copy = {d: torch.cuda.Stream(d) for d in dict.fromkeys(devices)}
    return StageMesh(devices, tuple(torch.cuda.Stream(d) for d in devices),
                     tuple(copy[d] for d in devices))


def _stage_devices(mesh: StageMesh) -> List[torch.device]:
    """The device of each pipeline stage."""
    return list(mesh.devices)


def peer_access(mesh: StageMesh) -> Dict[Tuple[int, int], bool]:
    """``torch.cuda.can_device_access_peer`` of each hop between two cards
    of the mesh, keyed by (sender, receiver) index; empty on one card.
    Without peer access a hop is copied through the host: still right,
    only slower."""
    out = {}
    for a, b in zip(mesh.devices, mesh.devices[1:]):
        if a != b and a.type == b.type == "cuda":
            out[(a.index, b.index)] = torch.cuda.can_device_access_peer(
                a.index, b.index)
    return out


def _on(stream: Optional[torch.cuda.Stream]):
    return torch.cuda.stream(stream)


def _check_mesh(plan: PlacementPlan, mesh: StageMesh) -> None:
    if plan.n_stages != mesh.n_stages:
        raise ValueError(f"plan has {plan.n_stages} stages, the mesh "
                         f"{mesh.n_stages}")


# ---------------------------------------------------------------------------
# the circular GPipe schedule (shared by the CNN and LM lowerings)
# ---------------------------------------------------------------------------
def _hop(x: torch.Tensor, done: Optional[torch.cuda.Event],
         device: torch.device,
         stream: Optional[torch.cuda.Stream]) -> torch.Tensor:
    """Hand a stage's output ``x`` to the next stage, which runs on
    ``device`` and ``stream`` (None off a card: the stages run in order,
    and ``x`` is moved, a no-op on the same device).  ``done`` is the
    event the sender recorded on its stream after making ``x``.

    * same card -- the reader's stream waits on ``done``, and ``x`` is
      handed on with ``record_stream`` (made on the sender's stream, read
      on this one).
    * another card -- the reader's stream waits on ``done`` (an event of
      another device), and a buffer of the reader's card, allocated on
      its stream, is filled with ``copy_(non_blocking=True)``.  PyTorch
      runs a copy between cards on the source card's current stream,
      fenced both ways with the reader's stream, so ``x`` is recorded on
      that stream: the sender's card does not reuse it before the copy is
      done."""
    if stream is None:
        return x.to(device)
    stream.wait_event(done)
    if x.device == device:
        x.record_stream(stream)
        return x
    with _on(stream):
        y = torch.empty_like(x, device=device)
        y.copy_(x, non_blocking=True)
    x.record_stream(torch.cuda.current_stream(x.device))
    return y


def _gpipe_outputs(stage_fns: Sequence[Callable[[torch.Tensor],
                                                torch.Tensor]],
                   streams: Sequence[Optional[torch.cuda.Stream]],
                   x_all: torch.Tensor,
                   devices: Optional[Sequence[torch.device]] = None
                   ) -> torch.Tensor:
    """Run the schedule of ``stage_fns`` (each maps a microbatch to one
    of the same shape) over ``x_all`` (M, mb, ...) on the first stage's
    device; ``devices`` are the stages' (default: all ``x_all``'s).
    Returns the last stage's (M, mb, ...) outputs on its device, finished
    (the host has synchronized the last stage's stream)."""
    n, m = len(stage_fns), x_all.shape[0]
    devices = list(devices or [x_all.device] * n)
    on_card = streams[0] is not None
    x_all = x_all.to(devices[0])
    outputs = torch.empty_like(x_all, device=devices[-1])
    if on_card:
        # x_all and outputs were made on the callers' streams
        for dev, st in zip(devices, streams):
            st.wait_stream(torch.cuda.current_stream(dev))
    names = stage_spans(n)
    hops: List[Any] = [None] * n    # (tensor, event) of stage s at step t-1
    for t in range(m + n - 1):
        handed: List[Any] = [None] * n
        for s in range(max(0, t - m + 1), min(n, t + 1)):
            with _on(streams[s]), span(names[s]):
                x = x_all[t] if s == 0 else _hop(*hops[s - 1], devices[s],
                                                 streams[s])
                y = stage_fns[s](x)
                if s == n - 1:
                    outputs[t - s].copy_(y)
                else:
                    handed[s] = (y, streams[s].record_event()
                                 if on_card else None)
        hops = handed
    if on_card:
        streams[-1].synchronize()
    return outputs


def _composed_outputs(stage_fns: Sequence[Callable[[torch.Tensor],
                                                   torch.Tensor]],
                      streams: Sequence[Optional[torch.cuda.Stream]],
                      devices: Sequence[torch.device],
                      x_all: torch.Tensor) -> torch.Tensor:
    """The same stage functions without the schedule: microbatch by
    microbatch, each stage in order on its device's current stream, moved
    between devices by a plain ``to`` -- the one-stream composition the
    schedule is held against.  Returns (M, mb, ...) on the last device."""
    for dev, st in zip(devices, streams):
        if st is not None:
            # what the stage functions close over (the weights made fp32)
            # was made on the stages' streams
            torch.cuda.current_stream(dev).wait_stream(st)
    outs = []
    for x in x_all:
        for dev, fn in zip(devices, stage_fns):
            x = fn(x.to(dev))
        outs.append(x)
    return torch.stack(outs)


def _pad_batch(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x`` with its first item repeated up to a multiple of ``m``."""
    b = x.shape[0]
    bp = -(-b // m) * m
    if bp == b:
        return x
    return torch.cat([x, x[:1].expand((bp - b,) + tuple(x.shape[1:]))])


# ---------------------------------------------------------------------------
# LM lowering: contiguous block ranges, unpadded uneven stages
# ---------------------------------------------------------------------------
def build_stage_blocks(blocks: Sequence[Params],
                       counts: Sequence[int]) -> List[List[Params]]:
    """Each stage's slice of the block list (the reference repacks its
    stacked blocks to (S, max_c, ...); a list needs no padding slots)."""
    offsets = [0, *itertools.accumulate(counts)]
    return [list(blocks[offsets[i]:offsets[i + 1]])
            for i in range(len(counts))]


def _lm_stage(cfg: lm.LMConfig, blocks: Sequence[Params],
              positions: torch.Tensor) -> Callable:
    """A stage body: exactly this stage's blocks, in order."""
    def apply(x: torch.Tensor) -> torch.Tensor:
        for bp in blocks:
            x = lm.block(cfg, bp, x, positions)
        return x
    return apply


def _to(tree: Params, device: torch.device,
        dtype: Optional[torch.dtype] = None) -> Params:
    """``tree`` on ``device`` (and in ``dtype``); leaves already there are
    kept, not copied."""
    return tree_map(lambda t: t.to(device, dtype), tree)


def make_pipeline_hidden(cfg: lm.LMConfig, mesh: StageMesh,
                         plan: PlacementPlan, n_microbatches: int):
    """Returns ``hidden_fn(params, batch) -> (B, S, D)`` hidden states in
    the model's dtype on the last stage's device, the blocks run as a
    pipeline per the plan.  The embedding runs on the first stage's
    device and each stage's blocks on its own (moved there when ``params``
    lie elsewhere); vlm: ``batch["embeds"]`` goes before the token
    embeddings and every stream gets (3, 1, S) positions."""
    _require_unreplicated(plan)
    _check_mesh(plan, mesh)
    counts = stage_block_counts(plan, cfg.n_layers)
    devices = _stage_devices(mesh)
    m = n_microbatches

    def hidden_fn(params: Params,
                  batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        first = devices[0]
        x = lm.embed_tokens(cfg, _to({"embed": params["embed"]}, first),
                            batch["tokens"].to(first))
        if cfg.family == "vlm" and "embeds" in batch:
            x = torch.cat([batch["embeds"].to(x.device, x.dtype), x], dim=1)
        b, s, d = x.shape
        if b % m:
            raise ValueError(f"batch {b} is not a multiple of "
                             f"{m} microbatches")
        stage_fns = [_lm_stage(cfg, _to(blocks, dev),
                               lm.positions_for(cfg, x[:1]).to(dev))
                     for blocks, dev in zip(
                         build_stage_blocks(params["blocks"], counts),
                         devices)]
        out = _gpipe_outputs(stage_fns, mesh.streams,
                             x.reshape(m, b // m, s, d), devices)
        return out.reshape(b, s, d)

    return hidden_fn


def pipeline_logits(cfg: lm.LMConfig, mesh: StageMesh, plan: PlacementPlan,
                    params: Params, batch: Dict[str, torch.Tensor],
                    n_microbatches: int = 4) -> torch.Tensor:
    """fp32 logits (B, S, V) of the pipelined forward on the last stage's
    device, in the model's dtype up to the unembedding
    (``lm.forward``'s)."""
    hidden_fn = make_pipeline_hidden(cfg, mesh, plan, n_microbatches)
    h = hidden_fn(params, batch)
    rest = {k: v for k, v in params.items() if k != "blocks"}
    return lm.unembed(cfg, _to(rest, h.device), h)


# ---------------------------------------------------------------------------
# CNN lowering: apply_subset ranges behind flat boundary buffers
# ---------------------------------------------------------------------------
def _cnn_stage_of(model: GraphModel, plan: PlacementPlan) -> Dict[str, int]:
    stage_of: Dict[str, int] = {}
    for s, layers in enumerate(plan.stage_layers):
        for name in layers:
            stage_of[name] = s
    missing = [n for n in model._order if n not in stage_of]
    if missing:
        raise ValueError(f"plan does not cover model layers {missing[:5]}; "
                         f"was it planned over {model.name}'s LayerGraph?")
    return stage_of


def cnn_boundary_specs(model: GraphModel, plan: PlacementPlan
                       ) -> Tuple[List[Specs], Specs]:
    """Per-stage input boundaries as ordered ``(name, shape)`` lists.

    ``B[s]`` is everything stage ``s`` reads that it does not compute:
    the model input for stage 0, and for later stages every tensor
    produced at a stage ``< s`` with a consumer at a stage ``>= s``
    (skip connections make these multi-tensor and make tensors ride
    through intermediate stages unchanged).  Also returns the packed
    output spec of the last stage."""
    S = plan.n_stages
    stage_of = _cnn_stage_of(model, plan)
    consumers: Dict[str, List[str]] = {}
    for name in model._order:
        for i in model.nodes[name].inputs:
            consumers.setdefault(i, []).append(name)
    B: List[Specs] = [[(GraphModel.INPUT, tuple(model.input_shape))]]
    for s in range(1, S):
        names: Specs = []
        if any(stage_of[c] >= s
               for c in consumers.get(GraphModel.INPUT, ())):
            names.append((GraphModel.INPUT, tuple(model.input_shape)))
        for name in model._order:
            if stage_of[name] >= s:
                continue
            if any(stage_of[c] >= s for c in consumers.get(name, ())):
                names.append((name, tuple(model.nodes[name].out_shape)))
        B.append(names)
    assert model.output is not None
    out_spec = [(model.output, tuple(model.nodes[model.output].out_shape))]
    return B, out_spec


def _specs_elems(specs: Sequence[Tuple[str, Tuple[int, ...]]]) -> int:
    return int(sum(int(np.prod(shape)) for _, shape in specs))


def _pack(acts: Dict[str, torch.Tensor], specs: Specs,
          flat: int) -> torch.Tensor:
    """The ``specs`` tensors of ``acts``, each (mb, ...), side by side in
    one (mb, flat) fp32 buffer, zero past their end."""
    first = acts[specs[0][0]]
    buf = first.new_empty((first.shape[0], flat), dtype=torch.float32)
    off = 0
    for name, shape in specs:
        n = int(np.prod(shape))
        buf[:, off:off + n] = acts[name].reshape(buf.shape[0], n)
        off += n
    buf[:, off:].zero_()
    return buf


def _unpack(buf: torch.Tensor, specs: Specs) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for name, shape in specs:
        n = int(np.prod(shape))
        out[name] = buf[:, off:off + n].reshape(
            (buf.shape[0],) + tuple(shape)).contiguous()
        off += n
    return out


def _channels_last(t: torch.Tensor) -> bool:
    """A conv weight held channels_last (it flattens in its memory order,
    so that it unflattens as a channels_last view)."""
    return (t.dim() == 4 and not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last))


def _flatten_stage_params(params: Params, layer_names: Sequence[str]):
    """One fp32 vector of a stage's parameters, and the layout that
    rebuilds them from it: ``(flat, treedef, layout)``."""
    sub = {n: params[n] for n in layer_names if n in params and params[n]}
    leaves, treedef = tree_flatten(sub)
    layout = [(tuple(t.shape), t.dtype, _channels_last(t)) for t in leaves]
    if not leaves:
        return torch.zeros((0,), dtype=torch.float32), treedef, layout
    flat = torch.cat([
        (t.permute(0, 2, 3, 1) if cl else t).reshape(-1).float()
        for t, (_, _, cl) in zip(leaves, layout)])
    return flat, treedef, layout


def _unflatten_stage_params(w: torch.Tensor, treedef, layout) -> Params:
    """The stage's parameters as views of ``w`` (fp32 leaves; others
    cast), conv weights that were channels_last channels_last again."""
    leaves, off = [], 0
    for shape, dtype, channels_last in layout:
        n = int(np.prod(shape)) if shape else 1
        part = w[off:off + n]
        if channels_last:
            o, i, h, k = shape
            leaf = part.view(o, h, k, i).permute(0, 3, 1, 2)
        else:
            leaf = part.view(shape)
        leaves.append(leaf.to(dtype))
        off += n
    return tree_unflatten(treedef, leaves)


def make_cnn_pipeline(model: GraphModel, plan: PlacementPlan,
                      mesh: StageMesh):
    """Boundary and packing metadata for lowering a CNN GraphModel + plan.

    Returns ``(B, out_spec, flat, make_branch)``: the per-stage input
    boundary specs, the packed output spec, the flat buffer width, and a
    factory ``make_branch(s, stage_params)`` of stage ``s``'s callable
    ``branch(buf) -> buf`` (unpack the boundary, ``apply_subset`` over the
    stage's layer range, pack the next boundary).
    :meth:`SpmdPipelineExecutor.for_cnn` runs these through the schedule;
    the achieved-time probes run them alone."""
    _require_unreplicated(plan)
    _check_mesh(plan, mesh)
    B, out_spec = cnn_boundary_specs(model, plan)
    flat = max(max(_specs_elems(b) for b in B), _specs_elems(out_spec))
    stage_layers = plan.stage_layers

    def make_branch(s: int, stage_params: Params):
        in_specs = B[s]
        nxt = B[s + 1] if s + 1 < plan.n_stages else out_spec

        def branch(buf: torch.Tensor) -> torch.Tensor:
            with span(BOUNDARY_SPAN):
                boundary = _unpack(buf, in_specs)
            acts = model.apply_subset(stage_params, boundary,
                                      stage_layers[s])
            with span(BOUNDARY_SPAN):
                return _pack({**boundary, **acts}, nxt, flat)

        return branch

    return B, out_spec, flat, make_branch


def _stage_rows(params: Params, plan: PlacementPlan, pin: bool):
    """One flat fp32 row of each stage's parameters, side by side in an
    (S, Wmax) host buffer (pinned when ``pin``; the reference's
    ``stacked_host``), and each row's ``(treedef, layout)``."""
    flats, layouts = [], []
    for layers in plan.stage_layers:
        w, treedef, layout = _flatten_stage_params(params, layers)
        flats.append(w)
        layouts.append((treedef, layout))
    wmax = max(1, max(f.numel() for f in flats))
    stacked = torch.zeros((plan.n_stages, wmax), pin_memory=pin)
    for s, f in enumerate(flats):
        stacked[s, :f.numel()].copy_(f)
    return stacked, layouts


class _CnnLowering:
    """Everything the executor needs for one CNN plan on one mesh, bar
    the weights (``layouts`` rebuilds each stage's from its row)."""

    def __init__(self, model: GraphModel, plan: PlacementPlan,
                 mesh: StageMesh, n_microbatches: int, layouts):
        self.m = n_microbatches
        B, out_spec, flat, self.make_branch = make_cnn_pipeline(
            model, plan, mesh)
        self.B, self.out_spec, self.flat = B, out_spec, flat
        self.layouts = layouts

    def branches(self, rows: Sequence[torch.Tensor]) -> List[Callable]:
        """Each stage's callable over its streamed weight row."""
        return [self.make_branch(s, _unflatten_stage_params(row, *layout))
                for s, (row, layout) in enumerate(zip(rows, self.layouts))]

    def pack_input(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        with span(BOUNDARY_SPAN):
            buf = _pack({GraphModel.INPUT: x}, self.B[0], self.flat)
            return buf.reshape(self.m, b // self.m, self.flat)

    def unpack_output(self, out_last: torch.Tensor, b: int) -> torch.Tensor:
        m, mb, _ = out_last.shape
        _, shape = self.out_spec[0]
        n = int(np.prod(shape))
        with span(BOUNDARY_SPAN):
            flat_out = out_last.reshape(m * mb, self.flat)
            return flat_out[:b, :n].reshape((b,) + tuple(shape))


# ---------------------------------------------------------------------------
# overlapped weight streaming
# ---------------------------------------------------------------------------
class StreamReport:
    """Timing record of one :func:`stream_stage_weights` call.

    * ``fill_s`` -- wall-clock bring-up fill: copies + ``compile_fn``.
    * ``blocked_s`` -- the part of ``fill_s`` the host spent waiting on
      the copies' events.  Overlapped issue lets the copies land behind
      ``compile_fn``; on a card they run on copy engines, so the wall fill
      can shrink as well.
    """

    __slots__ = ("fill_s", "blocked_s")

    def __init__(self, fill_s: float, blocked_s: float):
        self.fill_s = fill_s
        self.blocked_s = blocked_s

    def __repr__(self):
        return (f"StreamReport(fill_s={self.fill_s:.4f}, "
                f"blocked_s={self.blocked_s:.4f})")


def stream_stage_weights(mesh: StageMesh, stage_trees: Sequence[Params], *,
                         overlap: bool = True,
                         compile_fn: Optional[Callable[[], Any]] = None
                         ) -> Tuple[List[Params], Any, StreamReport]:
    """Copy each stage's weights (``stage_trees[s]``: a tree of host
    tensors, pinned for an asynchronous copy) to its stage's device, in
    their own dtype, on that card's copy stream, in stage order.

    * ``overlap=True`` -- every stage's copies are issued at once (the
      cards' copies run together, each over its own link) and
      ``compile_fn`` runs while they land.
    * ``overlap=False`` -- each stage's copies land before the next
      stage's are issued, and ``compile_fn`` runs after the last.

    Returns ``(stage trees on their devices, compile_fn's result,
    report)``; each stage's tensors may be used on its stream at once."""
    placed: List[Params] = [None] * len(stage_trees)
    compiled = None
    blocked_s = 0.0

    def issue(s: int):
        leaves, treedef = tree_flatten(stage_trees[s])
        dev, copy_stream = mesh.devices[s], mesh.copy_streams[s]
        with _on(copy_stream):
            placed[s] = tree_unflatten(treedef, [
                t.to(dev, non_blocking=True, copy=True) for t in leaves])
            return None if copy_stream is None else copy_stream.record_event()

    def drain(events) -> None:
        nonlocal blocked_s
        tw = time.perf_counter()
        for ev in events:
            if ev is not None:
                ev.synchronize()
        blocked_s += time.perf_counter() - tw

    t0 = time.perf_counter()
    if overlap:
        events = [issue(s) for s in range(len(stage_trees))]
        if compile_fn is not None:
            compiled = compile_fn()
        drain(events)
    else:
        for s in range(len(stage_trees)):
            drain([issue(s)])
        if compile_fn is not None:
            compiled = compile_fn()
    fill_s = time.perf_counter() - t0
    for tree, stream, copy_stream in zip(placed, mesh.streams,
                                         mesh.copy_streams):
        if copy_stream is not None:
            # made on the card's copy stream, read on the stage's
            for t in tree_flatten(tree)[0]:
                t.record_stream(stream)
    return placed, compiled, StreamReport(fill_s, blocked_s)


def _host_copy(t: torch.Tensor, pin: bool) -> torch.Tensor:
    """A copy of ``t`` in host memory, pinned (``pin``) so that a
    non-blocking copy to the card is asynchronous."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
    return out.copy_(t)


def host_stage_weights(model, params: Params, plan: PlacementPlan, *,
                       pin: bool = True) -> List[Params]:
    """What the executor streams, as host copies (pinned when ``pin``, so
    that the copies to the card are asynchronous): a GraphModel's one
    flat fp32 row per stage, an LMConfig's per-stage block lists in their
    own dtype.  The executor drops its own once they are on the card; a
    fill is measured again by streaming these with
    ``stream_stage_weights(ex.mesh, ..., compile_fn=ex.bring_up)``."""
    if isinstance(model, GraphModel):
        return list(_stage_rows(params, plan, pin)[0])
    counts = stage_block_counts(plan, model.n_layers)
    return [tree_map(lambda t: _host_copy(t, pin), blocks)
            for blocks in build_stage_blocks(params["blocks"], counts)]


def _bring_up(mesh: StageMesh, shape: Tuple[int, ...], dtype: torch.dtype,
              kernels: Sequence[str]) -> None:
    """The bring-up that needs only shapes: load the hand-written kernel
    libraries the lowering launches (built at first use), and reserve the
    schedule's buffers -- its (M, mb, ...) input on the first stage's card
    and output on the last's, on the callers' streams, and a microbatch
    hop on each stage's stream and card -- in the caching allocators, so
    the first run allocates no device memory of its own."""
    if not mesh.on_card:
        return
    for name in kernels:
        _build.load(name)
    keep = [torch.empty(shape, dtype=dtype, device=mesh.devices[0]),
            torch.empty(shape, dtype=dtype, device=mesh.devices[-1])]
    for dev, stream in zip(mesh.devices, mesh.streams):
        with _on(stream):
            keep.append(torch.empty(shape[1:], dtype=dtype, device=dev))
    del keep


def _sync(mesh: StageMesh) -> None:
    """Wait for the current stream of every card of the mesh."""
    for dev in mesh.cards:
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()


def _achieved(probe: Callable[[], Any], reps: int, warmup: int) -> float:
    for _ in range(warmup):
        probe()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        probe()
        samples.append(time.perf_counter() - t0)
    return float(np.median(samples))


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------
class SpmdPipelineExecutor:
    """Run an unreplicated PlacementPlan as a stream pipeline on the cards
    of its mesh.

    Mirrors the host :class:`~repro_torch.core.pipeline.PipelineExecutor`'s
    batch surface (``run_batch`` / ``close`` / context manager;
    ``start``/``stop`` do nothing more -- there are no worker threads) and
    adds the modeled-vs-real probes the SPMD tier exists for:

    * :attr:`fill_s` / :attr:`fill_blocked_s` -- bring-up fill cost
      (weight streaming + bring-up) and the host-blocked part of it,
      overlapped or serial per ``overlap_streaming`` (see
      :class:`StreamReport`); :attr:`bring_up` is the shape-only
      bring-up that ran as ``compile_fn``.
    * :meth:`predicted_stage_times` -- the plan's modeled per-stage times.
    * :meth:`achieved_stage_times` -- each stage's callable timed alone
      on its own stream and card.
    * :meth:`compose` -- the same stage callables and weights run without
      the schedule, the reference a pipelined call is held against when
      no card holds the whole model.
    """

    def __init__(self, *, kind: str, plan: PlacementPlan, mesh: StageMesh,
                 n_microbatches: int, fill_s: float,
                 overlap_streaming: bool, run_fn: Callable,
                 probe_fns: List[Callable[[], Callable[[], Any]]],
                 bring_up: Optional[Callable[[], Any]] = None,
                 fill_blocked_s: float = 0.0,
                 compose_fn: Optional[Callable] = None):
        self.kind = kind
        self.plan = plan
        self.mesh = mesh
        self.n_microbatches = n_microbatches
        self.fill_s = fill_s
        self.fill_blocked_s = fill_blocked_s
        self.overlap_streaming = overlap_streaming
        self._run = run_fn
        self._compose = compose_fn
        self._probe_fns = probe_fns
        self.bring_up = bring_up
        self._closed = False

    # -- construction -------------------------------------------------------
    @classmethod
    def for_model(cls, model, params, plan: PlacementPlan, **kw
                  ) -> "SpmdPipelineExecutor":
        """Dispatch on the model object: a GraphModel lowers via
        apply_subset ranges, an LM config via block ranges."""
        if isinstance(model, GraphModel):
            return cls.for_cnn(model, params, plan, **kw)
        if hasattr(model, "n_layers") and hasattr(model, "family"):
            return cls.for_lm(model, params, plan, **kw)
        raise TypeError(f"cannot lower {type(model).__name__} onto the "
                        f"SPMD pipeline; pass a GraphModel or an LMConfig")

    @classmethod
    def for_cnn(cls, model: GraphModel, params: Params,
                plan: PlacementPlan, *, mesh: Optional[StageMesh] = None,
                n_microbatches: int = 4, overlap_streaming: bool = True,
                batch_size: Optional[int] = None) -> "SpmdPipelineExecutor":
        """``model``'s fp32 weights (``params``, on any device) streamed
        from a pinned (S, Wmax) host copy of one flat row per stage, each
        row to its stage's card, and the host copy dropped once they are
        there.  Calls take (B, H, W, C) images and return the output
        node's (B, ...) activations on the last stage's device."""
        _require_unreplicated(plan)
        if mesh is None:
            mesh = default_stage_mesh(plan.n_stages)
        devices = _stage_devices(mesh)
        stacked, layouts = _stage_rows(params, plan, mesh.on_card)
        low = _CnnLowering(model, plan, mesh, n_microbatches, layouts)
        m = n_microbatches
        bring_up = None
        if batch_size is not None:
            shape = (m, -(-batch_size // m), low.flat)
            bring_up = functools.partial(_bring_up, mesh, shape,
                                         torch.float32, ())
        rows, _, stream = stream_stage_weights(
            mesh, list(stacked), overlap=overlap_streaming,
            compile_fn=bring_up)
        del stacked
        stage_fns = low.branches(rows)

        def run_with(pipe: Callable) -> Callable:
            def run(x: torch.Tensor) -> torch.Tensor:
                b = x.shape[0]
                x = _pad_batch(x.to(devices[0], torch.float32), m)
                return low.unpack_output(pipe(low.pack_input(x)), b)
            return run

        mb_probe = max(1, (batch_size or m) // m)

        def make_probe(s):
            def build():
                buf = torch.zeros((mb_probe, low.flat), device=devices[s])
                return _stage_probe(stage_fns[s], mesh.streams[s], buf)
            return build

        return cls(kind="cnn", plan=plan, mesh=mesh, n_microbatches=m,
                   fill_s=stream.fill_s, fill_blocked_s=stream.blocked_s,
                   overlap_streaming=overlap_streaming,
                   run_fn=run_with(lambda xs: _gpipe_outputs(
                       stage_fns, mesh.streams, xs, devices)),
                   compose_fn=run_with(lambda xs: _composed_outputs(
                       stage_fns, mesh.streams, devices, xs)),
                   probe_fns=[make_probe(s) for s in range(plan.n_stages)],
                   bring_up=bring_up)

    @classmethod
    def for_lm(cls, cfg: lm.LMConfig, params: Params, plan: PlacementPlan,
               *, mesh: Optional[StageMesh] = None, n_microbatches: int = 4,
               overlap_streaming: bool = True,
               batch_size: Optional[int] = None,
               seq_len: Optional[int] = None) -> "SpmdPipelineExecutor":
        """The block ranges of a dense or moe ``cfg``: each stage's blocks
        streamed in the model's dtype from pinned host copies to its
        stage's card (the copies dropped once they are there), then made
        fp32 there; the embedding in fp32 on the first stage's card, the
        final norm and head on the last's.  Calls take (B, S) tokens, run
        the blocks on fp32 activations and return fp32 logits (B, S, V) on
        the last stage's device (the reference's numerics).  ``params``
        may lie on the host: a model that no card holds is streamed
        stage by stage."""
        _require_unreplicated(plan)
        if cfg.family not in ("dense", "moe"):
            raise ValueError(f"SPMD LM executor supports the dense/moe "
                             f"scan-block families, not {cfg.family!r}")
        if mesh is None:
            mesh = default_stage_mesh(plan.n_stages)
        _check_mesh(plan, mesh)
        devices = _stage_devices(mesh)
        m = n_microbatches
        # the embedding (an fp32 table gives the bf16 rows' values
        # exactly) on the first card, the final norm and head on the last,
        # in fp32; one copy of a leaf a card
        placed: Dict[Tuple[str, torch.device], Params] = {}

        def put(key: str, dev: torch.device) -> Params:
            if (key, dev) not in placed:
                placed[key, dev] = _to(params[key], dev, torch.float32)
            return placed[key, dev]

        rest_in = {"embed": put("embed", devices[0])}
        rest_out = {k: put(k, devices[-1]) for k in (
            "final_norm", "embed" if cfg.tie_embeddings else "head")}
        bring_up = None
        if batch_size is not None and seq_len is not None:
            shape = (m, -(-batch_size // m), seq_len, cfg.d_model)
            bring_up = functools.partial(_bring_up, mesh, shape,
                                         torch.float32, ("flash_attention",))
        streamed, _, stream = stream_stage_weights(
            mesh, host_stage_weights(cfg, params, plan, pin=mesh.on_card),
            overlap=overlap_streaming, compile_fn=bring_up)
        blocks32 = []
        for tree, st in zip(streamed, mesh.streams):
            with _on(st):
                blocks32.append(tree_map(torch.Tensor.float, tree))
        del streamed

        def stage_fns_at(seq: int) -> List[Callable]:
            return [_lm_stage(cfg, blocks,
                              torch.arange(seq, device=dev)[None, :])
                    for blocks, dev in zip(blocks32, devices)]

        def run_with(pipe: Callable) -> Callable:
            def run(tokens: torch.Tensor) -> torch.Tensor:
                b = tokens.shape[0]
                tokens = _pad_batch(tokens.to(devices[0]), m)
                x = lm.embed_tokens(cfg, rest_in, tokens)
                bp, s, d = x.shape
                h = pipe(stage_fns_at(s), x.reshape(m, bp // m, s, d))
                return lm.unembed(cfg, rest_out, h.reshape(bp, s, d))[:b]
            return run

        mb_probe = max(1, (batch_size or m) // m)
        probe_seq = seq_len or 16

        def make_probe(s):
            def build():
                x0 = torch.zeros((mb_probe, probe_seq, cfg.d_model),
                                 device=devices[s])
                return _stage_probe(stage_fns_at(probe_seq)[s],
                                    mesh.streams[s], x0)
            return build

        return cls(kind="lm", plan=plan, mesh=mesh, n_microbatches=m,
                   fill_s=stream.fill_s, fill_blocked_s=stream.blocked_s,
                   overlap_streaming=overlap_streaming,
                   run_fn=run_with(lambda fns, xs: _gpipe_outputs(
                       fns, mesh.streams, xs, devices)),
                   compose_fn=run_with(lambda fns, xs: _composed_outputs(
                       fns, mesh.streams, devices, xs)),
                   probe_fns=[make_probe(s) for s in range(plan.n_stages)],
                   bring_up=bring_up)

    # -- execution ----------------------------------------------------------
    def __call__(self, batch: torch.Tensor) -> torch.Tensor:
        if self._closed:
            raise RuntimeError("executor is closed")
        with span(CALL_SPAN):
            return self._run(batch)

    def compose(self, batch: torch.Tensor) -> torch.Tensor:
        """``batch`` through the same stage callables and weights as a
        call, without the schedule: microbatch by microbatch, each stage
        in order on its card's current stream, moved between cards by a
        plain ``to`` (one card: the one-stream composition)."""
        if self._closed:
            raise RuntimeError("executor is closed")
        return self._compose(batch)

    def run_batch(self, items: Sequence[Any]) -> Tuple[List[Any], Dict]:
        """Host-executor-shaped batch entry: a list of unbatched items in,
        a list of outputs + a stats record out (``batch_s`` ends with the
        device finished)."""
        x = torch.stack([torch.as_tensor(i) for i in items])
        t0 = time.perf_counter()
        out = self(x)
        _sync(self.mesh)
        dt = time.perf_counter() - t0
        stats = {"batch_s": dt, "items_per_s": len(items) / dt,
                 "fill_s": self.fill_s,
                 "fill_blocked_s": self.fill_blocked_s,
                 "n_microbatches": self.n_microbatches}
        return [out[i] for i in range(len(items))], stats

    # -- modeled-vs-real probes ---------------------------------------------
    def predicted_stage_times(self) -> List[Optional[float]]:
        """The plan's modeled per-stage seconds (the placement DP's view)."""
        return list(self.plan.stage_times_s)

    def achieved_stage_times(self, reps: int = 5, warmup: int = 2
                             ) -> List[float]:
        """Each stage's callable timed alone on its own stream and card
        (host clock ending in that stream's synchronize; median of
        ``reps``): the 'achieved' column of the modeled-vs-real loop."""
        return [_achieved(build(), reps, warmup) for build in self._probe_fns]

    # -- lifecycle (host-executor parity) ------------------------------------
    def start(self) -> "SpmdPipelineExecutor":
        return self          # no worker threads to start

    def stop(self) -> None:
        self.close()

    def close(self) -> None:
        self._closed = True

    def __enter__(self) -> "SpmdPipelineExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _stage_probe(fn: Callable, stream: Optional[torch.cuda.Stream],
                 x: torch.Tensor) -> Callable[[], None]:
    """``fn(x)`` on ``stream``, returning once the stream has finished."""
    def probe() -> None:
        if stream is not None:
            # x, and what fn closes over, were made on the caller's stream
            stream.wait_stream(torch.cuda.current_stream(x.device))
        with _on(stream):
            fn(x)
        if stream is not None:
            stream.synchronize()
    return probe
