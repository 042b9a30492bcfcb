from .adamw import (
    AdamWConfig,
    AdamWState,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_adamw,
    schedule_lr,
)
from .diloco import DilocoConfig, DilocoState, init_diloco, outer_step, outer_step_group

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "DilocoConfig",
    "DilocoState",
    "adamw_update",
    "clip_by_global_norm",
    "global_norm",
    "init_adamw",
    "init_diloco",
    "outer_step",
    "outer_step_group",
    "schedule_lr",
]
