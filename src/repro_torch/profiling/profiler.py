"""Layer-granular profiler: run the model depth-by-depth and time it.

Ported from ``repro/profiling/profiler.py``.  This plays the role the real
Edge TPU + ``perf`` harness plays in the paper (§5): measure per-layer
inference time on the executing device (here the CUDA card), so the
planner can balance *measured* stage times instead of the analytic model's
prediction.  The unit of measurement is one **depth level** — the same
granularity the horizontal-cut segmentation operates on (§6.1.1), so the
trace maps 1:1 onto the planner's per-depth cost arrays.

Method: one forward pass records the boundary activations entering every
depth level; each level is then re-executed in isolation through
``GraphModel.apply_subset`` (the exact code path the pipelined executor
runs per stage) under ``time.perf_counter``, with ``warmup`` discarded
runs, ``repeats`` timed runs, and a trimmed mean over the repeats
(``torch.cuda.synchronize`` fences every run on a card — asynchronous
launches would otherwise attribute one level's work to the next).  The
trace is the reference's ``repro.profile_trace/v1`` document, so the
reference's ``ProfileTrace.from_json`` reads a trace captured here.
"""
from __future__ import annotations

import math
import time
from typing import Sequence

import torch

from .. import resolve_device
from .trace import DepthSample, ProfileTrace


def trimmed_mean(values: Sequence[float], trim: float = 0.2) -> float:
    """Mean of ``values`` with ``floor(trim * n)`` dropped from each end —
    robust to the scheduler hiccups that plague short wall-clock timings."""
    if not values:
        raise ValueError("trimmed_mean of no values")
    vals = sorted(values)
    k = int(math.floor(trim * len(vals)))
    kept = vals[k:len(vals) - k] or [vals[len(vals) // 2]]
    return sum(kept) / len(kept)


# roofline knee separating the compute-bound from the memory-bound layer
# regime: a 3x3 depthwise conv produces ~9 MACs per activation byte, a
# pointwise conv ~its channel count — devices execute the two regimes at
# very different MAC rates, so the calibration fits them separately
LOW_INTENSITY_MACS_PER_BYTE = 32.0


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_model(model, *, warmup: int = 1, repeats: int = 5,
                  trim: float = 0.2, batch: int = 1, seed: int = 0,
                  device="cuda", stamp_time: bool = True) -> ProfileTrace:
    """Capture a :class:`ProfileTrace` of a ``GraphModel`` on ``device``.

    ``model`` is any :class:`repro_torch.models.layers.GraphModel` (the CNN
    zoo and the synthetic family both build one).  Parameters and the
    input are drawn fresh from ``seed`` on ``device`` — the profile
    measures op time, which is weight-value independent.  The trace names
    the card (``torch.cuda.get_device_name``), or ``"cpu"``.
    """
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    dev = resolve_device(device)
    graph = model.to_layer_graph()
    levels = graph.levels()
    params_pd = graph.params_per_depth()
    macs_pd = graph.macs_per_depth()
    bytes_pd = graph.bytes_per_depth()
    act_pd = [sum(graph.nodes[n].out_bytes for n in lvl) for lvl in levels]
    low_pd = [sum(graph.nodes[n].macs for n in lvl
                  if graph.nodes[n].macs <= LOW_INTENSITY_MACS_PER_BYTE
                  * max(1, graph.nodes[n].out_bytes))
              for lvl in levels]

    params = model.init(dev, torch.Generator(dev).manual_seed(seed))
    x = torch.randn((batch,) + tuple(model.input_shape),
                    generator=torch.Generator(dev).manual_seed(seed + 1),
                    device=dev)

    # one recording pass: the boundary activations entering each depth
    # level, pruned to the inputs that level actually consumes (keeping a
    # full snapshot per level would pin every earlier activation for the
    # whole run on deep models)
    acts = {model.INPUT: x}
    boundaries = []
    for lvl in levels:
        need = {i for n in lvl for i in model.nodes[n].inputs}
        boundaries.append({k: acts[k] for k in need if k in acts})
        outs = model.apply_subset(params, acts, lvl)
        acts.update(outs)
    _fence(dev)
    acts = None

    samples = []
    for d, lvl in enumerate(levels):
        boundary = boundaries[d]

        def run_level():
            out = model.apply_subset(params, boundary, lvl)
            _fence(dev)
            return out

        for _ in range(warmup):
            run_level()
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            run_level()
            times.append(time.perf_counter() - t0)
        samples.append(DepthSample(
            depth=d, time_s=trimmed_mean(times, trim),
            layers=tuple(lvl), params=params_pd[d], macs=macs_pd[d],
            weight_bytes=bytes_pd[d], act_bytes=act_pd[d],
            low_intensity_macs=low_pd[d], raw_times_s=tuple(times)))

    label = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else dev.type)
    return ProfileTrace(
        graph_name=graph.name, samples=tuple(samples), device=label,
        warmup=warmup, repeats=repeats, trim=trim, batch=batch,
        captured_unix_s=time.time() if stamp_time else 0.0)
