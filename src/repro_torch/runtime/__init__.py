from .failure import HeartbeatMonitor, RecoveryPlan, WorkerState, optimal_checkpoint_interval, plan_recovery
from .straggler import StragglerMonitor, StragglerReport
from .trainer import GeoTrainer, TrainerConfig

__all__ = [
    "GeoTrainer",
    "HeartbeatMonitor",
    "RecoveryPlan",
    "StragglerMonitor",
    "StragglerReport",
    "TrainerConfig",
    "WorkerState",
    "optimal_checkpoint_interval",
    "plan_recovery",
]
