"""Cross-pod training on one device: compression, sync strategies, the train step."""

from .compression import Int8Compressed, int8_compress, int8_decompress
from .steps import TrainState, init_train_state, make_train_step, pod_grads, sync_grads
from .sync import STRATEGIES, sync_allreduce, sync_hier, sync_hier_int8, wan_bytes_per_step

__all__ = [
    "STRATEGIES",
    "Int8Compressed",
    "TrainState",
    "init_train_state",
    "int8_compress",
    "int8_decompress",
    "make_train_step",
    "pod_grads",
    "sync_allreduce",
    "sync_grads",
    "sync_hier",
    "sync_hier_int8",
    "wan_bytes_per_step",
]
