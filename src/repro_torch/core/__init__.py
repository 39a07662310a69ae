"""Core of the paper's contribution: balanced DAG segmentation for
multi-accelerator pipelined inference (SEGM_COMP / SEGM_PROF / SEGM_BALANCED),
extended with topology-aware placement (heterogeneous devices, replicated
bottleneck stages)."""
from .graph import LayerGraph, LayerNode, chain_graph
from .segmentation import (balanced_split, comp_split, dp_split, imbalance,
                           max_segment, minimax_time_split, placement_split,
                           prof_split, segment_ranges, segment_sums,
                           split_check)
from .cost_engine import SegmentCostEngine
from .refine import GraphReporter, RefinementResult, refine_cuts
from .topology import DeviceSpec, Topology, TopologyCostModel
from .placement import (PlacementPlan, SegmentationPlan, StagePlacement,
                        min_stages_no_spill, min_stages_to_fit)
from .edge_tpu_model import EdgeTPUModel, EdgeTPUSpec, MemoryReport
from .pipeline import (PipelineExecutor, PipelineStopped, ReplicaFailure,
                       ShapeKeyedStageCache, StageLost, simulated_stage,
                       stage_balance_metrics)

__all__ = [
    "LayerGraph", "LayerNode", "chain_graph",
    "balanced_split", "comp_split", "dp_split", "minimax_time_split",
    "placement_split", "prof_split", "split_check",
    "segment_sums", "segment_ranges", "max_segment", "imbalance",
    "SegmentCostEngine",
    "GraphReporter", "RefinementResult", "refine_cuts",
    "DeviceSpec", "Topology", "TopologyCostModel",
    "PlacementPlan", "SegmentationPlan", "StagePlacement",
    "min_stages_to_fit", "min_stages_no_spill",
    "EdgeTPUModel", "EdgeTPUSpec", "MemoryReport",
    "PipelineExecutor", "PipelineStopped", "ReplicaFailure", "StageLost",
    "ShapeKeyedStageCache", "simulated_stage", "stage_balance_metrics",
]
