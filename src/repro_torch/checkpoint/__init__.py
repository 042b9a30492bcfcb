from .store import AsyncCheckpointer, CheckpointInfo, CheckpointStore

__all__ = ["AsyncCheckpointer", "CheckpointInfo", "CheckpointStore"]
