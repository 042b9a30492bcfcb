from .adamw import (
    AdamWConfig,
    AdamWState,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_adamw,
    schedule_lr,
)

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "adamw_update",
    "clip_by_global_norm",
    "global_norm",
    "init_adamw",
    "schedule_lr",
]
