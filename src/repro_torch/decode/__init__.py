"""Decode serving tier: KV-cache-aware placement + continuous batching.

The port of ``repro/decode``.  Autoregressive decode inverts the paper's
memory economy: stage feasibility is dominated by the *growing KV cache* --
``(context_len, n_kv_heads, head_dim)`` times the number of concurrent
sequences -- not by static weight bytes.  This package layers a second cost
regime on the same planner:

* :mod:`repro_torch.decode.costing` -- :class:`DecodeCostSource`: per-token
  decode compute + per-sequence state bytes per depth, through the
  :class:`~repro_torch.core.cost_engine.SegmentCostEngine` seam (a copy).
* :mod:`repro_torch.decode.placement` -- the ``decode_placement``
  strategy: maximize steady-state tokens/s subject to a per-stage KV cap
  at a ``(concurrency, max_context)`` operating point (a copy; a caller's
  full-width config reaches it through ``plan(..., cfg=)``).
* :mod:`repro_torch.decode.scheduler` -- :class:`DecodeScheduler`:
  continuous batching (a copy).
* :mod:`repro_torch.decode.engine` -- :class:`PipelineDecodeEngine`: the
  decode batch through the streaming executor, one stage per plan segment
  on its own CUDA stream, per-stage KV caches on the card, every decode
  step's attention in the flash-decode kernel.

Front door: ``DeploymentSpec(model="lm:...", workload="decode",
max_context=..., decode_concurrency=...)`` -> ``deploy(spec, graph=,
cfg=, base_spec=)`` -> ``Deployment.serve(params=)`` streaming tokens.
"""
from .costing import (DecodeCostSource, DecodeOperatingPoint,
                      decode_depth_costs)
from .engine import (DecodeServer, PipelineDecodeEngine,
                     build_decode_server)
from .placement import (DECODE_FAMILIES, decode_config_for,
                        max_feasible_concurrency)
from .scheduler import DecodeRequest, DecodeScheduler

__all__ = [
    "DecodeCostSource", "DecodeOperatingPoint", "decode_depth_costs",
    "DecodeRequest", "DecodeScheduler", "DecodeServer",
    "PipelineDecodeEngine", "build_decode_server",
    "DECODE_FAMILIES", "decode_config_for", "max_feasible_concurrency",
]
