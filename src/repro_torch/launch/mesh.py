"""Card grids and the H100's constants, as ``repro/launch/mesh.py`` holds
the TPU mesh functions and the v5e's.

A :class:`Grid` is the dry-run's device grid as plain integers: no device
is touched or faked.  It has the reference mesh's axis names (``pod`` only
where the reference's multi-pod mesh has one, then ``data`` and
``model``) and its ``shape`` mapping, which is all the dry-run's rules
read.  ``GRIDS`` holds the three the dry-run takes: one card (``1x1``),
the reference's pod (``16x16``) and two pods (``2x16x16``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

# NVIDIA H100 SXM5 80GB (data sheet): dense bf16 tensor-core peak, HBM3
# bandwidth and memory of one card; the roofline denominators of the port
PEAK_FLOPS_BF16 = 989e12        # FLOP/s per H100
HBM_BW = 3.35e12                # bytes/s per H100
HBM_BYTES = 80e9                # bytes per H100 (its "80GB")


@dataclasses.dataclass(frozen=True)
class Grid:
    data: int = 1
    model: int = 1
    pod: Optional[int] = None   # pods (the reference's multi-pod axis)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (("pod",) if self.pod else ()) + ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        sizes = {"data": self.data, "model": self.model}
        return {"pod": self.pod, **sizes} if self.pod else sizes

    @property
    def n_devices(self) -> int:
        return self.data * self.model * (self.pod or 1)

    @property
    def name(self) -> str:
        return "x".join(str(self.shape[a]) for a in self.axis_names)


GRIDS: Dict[str, Grid] = {g.name: g for g in (
    Grid(1, 1), Grid(16, 16), Grid(16, 16, pod=2))}


def data_axes(grid: Grid) -> Tuple[str, ...]:
    """Axes the batch dimension shards over (pod+data when present)."""
    return tuple(a for a in ("pod", "data") if a in grid.axis_names)


def model_axis_size(grid: Grid) -> int:
    return grid.shape.get("model", 1)


def data_parallel_size(grid: Grid) -> int:
    out = 1
    for a in data_axes(grid):
        out *= grid.shape[a]
    return out
