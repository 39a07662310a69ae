"""ProfileTrace: a persisted, versioned record of per-depth measured times.

The paper's segmentation is *profile-based*: per-layer inference times are
measured on the real device and drive the balanced cuts (§5).  This module
is the artifact side of that loop — a layer-granular profile captured by
:mod:`repro_torch.profiling.profiler`, serialized to JSON, and consumed by the
:class:`~repro_torch.profiling.sources.TraceCostSource` /
:class:`~repro_torch.profiling.sources.CalibratedCostSource` planner inputs.

Schema stability rules (the document ships between machines and releases):

* ``format`` is ``repro.profile_trace/v1``; loaders accept any document
  whose major version matches (``repro.profile_trace/v1*``) and reject
  other formats loudly.
* Unknown fields — at the trace level and the per-sample level — are
  **ignored**, not errors: a newer profiler may annotate more columns and
  an older planner must still read the times (regression-tested in
  tests/test_profiling.py).
* ``from_json(to_json(trace))`` round-trips exactly (floats included).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

TRACE_FORMAT = "repro.profile_trace/v1"


def _known_fields(cls, doc: Dict) -> Dict:
    """Filter a document to the dataclass' declared fields (unknown-field
    tolerance: newer writers may add columns)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in doc.items() if k in names}


@dataclasses.dataclass(frozen=True)
class DepthSample:
    """One depth level's measurement: the trimmed-mean wall time of running
    every layer at that depth once, plus the static costs the calibration
    fit regresses against."""

    depth: int
    time_s: float
    layers: Tuple[str, ...] = ()
    params: int = 0
    macs: int = 0
    weight_bytes: int = 0
    act_bytes: int = 0          # activation bytes produced by the level
    low_intensity_macs: int = 0  # MACs in layers below the roofline knee
                                 # (MACs/act-byte < threshold: depthwise
                                 # convs, pooling — memory-bound regime)
    raw_times_s: Tuple[float, ...] = ()     # every repeat, for audit

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["layers"] = list(self.layers)
        d["raw_times_s"] = list(self.raw_times_s)
        return d

    @classmethod
    def from_dict(cls, doc: Dict) -> "DepthSample":
        doc = _known_fields(cls, doc)
        doc["layers"] = tuple(doc.get("layers", ()))
        doc["raw_times_s"] = tuple(doc.get("raw_times_s", ()))
        return cls(**doc)


@dataclasses.dataclass(frozen=True)
class ProfileTrace:
    """A layer-granular profile of one model on one device.

    ``samples`` need not cover every depth of the graph — a partial trace
    is legal, and the cost sources fall back to the analytic model for
    unprofiled depths.
    """

    graph_name: str
    samples: Tuple[DepthSample, ...]
    device: str = "host-cpu"
    warmup: int = 0
    repeats: int = 1
    trim: float = 0.0
    batch: int = 1
    captured_unix_s: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "samples", tuple(self.samples))

    # -- queries -------------------------------------------------------------
    def depth_time_map(self) -> Dict[int, float]:
        return {s.depth: s.time_s for s in self.samples}

    @property
    def depths(self) -> Tuple[int, ...]:
        return tuple(s.depth for s in self.samples)

    @property
    def total_time_s(self) -> float:
        return sum(s.time_s for s in self.samples)

    def coverage(self, n_depths: int) -> float:
        """Fraction of ``n_depths`` depth levels the trace covers."""
        if n_depths <= 0:
            return 0.0
        covered = sum(1 for s in self.samples if 0 <= s.depth < n_depths)
        return covered / n_depths

    def stage_times(self, ranges: Sequence[Tuple[int, int]]
                    ) -> Optional[List[float]]:
        """Measured compute time per stage (sum of the stage's depth
        samples), or None when any stage touches an unprofiled depth —
        a partial trace cannot price a plan's stages honestly."""
        tmap = self.depth_time_map()
        out: List[float] = []
        for lo, hi in ranges:
            try:
                out.append(sum(tmap[d] for d in range(lo, hi + 1)))
            except KeyError:
                return None
        return out

    def describe(self) -> str:
        return (f"trace[{self.graph_name} @ {self.device}]: "
                f"{len(self.samples)} depths, "
                f"{self.total_time_s * 1e3:.2f} ms total, "
                f"{self.repeats} repeats (trim {self.trim})")

    # -- (de)serialization ---------------------------------------------------
    def to_dict(self) -> Dict:
        return {
            "format": TRACE_FORMAT,
            "graph_name": self.graph_name,
            "device": self.device,
            "warmup": self.warmup,
            "repeats": self.repeats,
            "trim": self.trim,
            "batch": self.batch,
            "captured_unix_s": self.captured_unix_s,
            "samples": [s.to_dict() for s in self.samples],
        }

    @classmethod
    def from_dict(cls, doc: Dict) -> "ProfileTrace":
        fmt = doc.get("format")
        if not isinstance(fmt, str) or not fmt.startswith(TRACE_FORMAT):
            raise ValueError(f"not a profile trace document: {fmt!r} "
                             f"(expected {TRACE_FORMAT})")
        body = _known_fields(cls, doc)
        body.pop("samples", None)
        samples = tuple(DepthSample.from_dict(s)
                        for s in doc.get("samples", ()))
        return cls(samples=samples, **{k: v for k, v in body.items()
                                       if k != "samples"})

    def to_json(self, indent: Optional[int] = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "ProfileTrace":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @classmethod
    def load(cls, path: str) -> "ProfileTrace":
        with open(path) as f:
            return cls.from_json(f.read())
