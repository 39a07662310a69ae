from .server import (DeadlineExceeded, MicroBatcher, Overloaded,
                     PipelinedModelServer, Request, latency_percentiles)
from ..core.pipeline import PipelineStopped

__all__ = ["Request", "MicroBatcher", "PipelinedModelServer",
           "PipelineStopped", "latency_percentiles",
           "DeadlineExceeded", "Overloaded"]
