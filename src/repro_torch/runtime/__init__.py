from .elastic import ElasticCoordinator, MeshPlan, plan_remesh, reshard_tree
from .failure import HeartbeatMonitor, RecoveryPlan, WorkerState, optimal_checkpoint_interval, plan_recovery
from .straggler import StragglerMonitor, StragglerReport
from .trainer import GeoTrainer, TrainerConfig

__all__ = [
    "ElasticCoordinator",
    "GeoTrainer",
    "HeartbeatMonitor",
    "MeshPlan",
    "RecoveryPlan",
    "StragglerMonitor",
    "StragglerReport",
    "TrainerConfig",
    "WorkerState",
    "optimal_checkpoint_interval",
    "plan_recovery",
    "plan_remesh",
    "reshard_tree",
]
