from .ft import (ElasticPlanner, FailureInjector, FaultPolicy,
                 HealthMonitor, TrainSupervisor)
from .straggler import SpeculativeExecutor
from .chaos import (ChaosEvent, ChaosMonkey, ChaosReport,
                    replica_kill_schedule, run_chaos_executor)
from .selfheal import DriftDetector, DriftPolicy, SelfHealingController

__all__ = ["TrainSupervisor", "FailureInjector", "ElasticPlanner",
           "FaultPolicy", "HealthMonitor", "SpeculativeExecutor",
           "ChaosEvent", "ChaosMonkey", "ChaosReport",
           "replica_kill_schedule", "run_chaos_executor",
           "DriftDetector", "DriftPolicy", "SelfHealingController"]
