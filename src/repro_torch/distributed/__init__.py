"""Cross-pod training on one device: compression, sync strategies, the train step."""

from .compression import Int8Compressed, int8_compress, int8_decompress, topk_densify, topk_sparsify
from .steps import TrainState, init_pod_params, init_train_state, make_train_step, pod_grads, sync_grads
from .sync import (
    STRATEGIES,
    full_precision_bytes,
    ps_bytes,
    sync_allreduce,
    sync_hier,
    sync_hier_int8,
    sync_local,
    sync_ps,
    wan_bytes_per_step,
)

__all__ = [
    "STRATEGIES",
    "Int8Compressed",
    "TrainState",
    "full_precision_bytes",
    "init_pod_params",
    "init_train_state",
    "int8_compress",
    "int8_decompress",
    "make_train_step",
    "pod_grads",
    "ps_bytes",
    "sync_allreduce",
    "sync_grads",
    "sync_hier",
    "sync_hier_int8",
    "sync_local",
    "sync_ps",
    "topk_densify",
    "topk_sparsify",
    "wan_bytes_per_step",
]
