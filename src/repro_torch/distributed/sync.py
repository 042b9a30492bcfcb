"""Cross-pod (inter-data-center) gradient synchronisation on one device.

Port of ``repro.distributed.sync``.  The JAX functions run inside
``shard_map`` with a manual ``"pod"`` axis; one H100 cannot hold a process
per pod, so here the pod axis is the LEADING dimension of every gradient
leaf, ``[npods, ...]``: a ``psum`` over pods becomes a sum over that
dimension, and the all-gather of the int8 payloads is the stacked tensor
itself.  Each function computes what its JAX counterpart computes under
``jax.vmap(..., axis_name="pod")``; the synced gradient, identical on every
pod there, is returned once.

* ``allreduce``  -- flat mean over pods (the paper's M2 / DDP setting);
* ``hier``       -- the same bytes, each leaf split along its leading dim
                    into ``num_channels`` separate reductions (§3.3 striping);
* ``hier_int8``  -- ``hier`` with int8 + error feedback on the WAN hop, the
                    quantiser being the ``wan_quant`` kernels;
* ``ps``         -- parameter server (the survey's M1): each pod pushes its
                    float32 gradients, the server averages them and every
                    pod pulls the updated parameters;
* ``local_sgd``  -- no gradient sync at all: each pod steps alone and the
                    DiLoCo outer step (:mod:`repro_torch.optim.diloco`)
                    averages the pods' parameter deltas every H steps.
"""

from __future__ import annotations

import torch

from .compression import (
    apply_error_feedback,
    compressed_bytes,
    int8_compress,
    int8_decompress,
    residual,
)
from ..tree import tree_leaves, tree_map

STRATEGIES = ("allreduce", "ps", "hier", "hier_int8", "local_sgd")


def _chunk_bounds(dim0: int, num_channels: int):
    """Static slice bounds splitting dim 0 into <= num_channels parts."""
    base, rem = divmod(dim0, num_channels)
    bounds, start = [], 0
    for i in range(num_channels):
        size = base + (1 if i < rem else 0)
        if size == 0:
            break
        bounds.append((start, size))
        start += size
    return bounds


def sync_allreduce(grads):
    """Flat cross-pod mean (paper M2).  grads: leaves [npods, ...]."""
    return tree_map(lambda g: g.float().sum(0) / g.shape[0], grads)


def sync_ps(grads):
    """The parameter server's average of the pushed float32 gradients: the
    JAX step's all-gather over pods, then ``.mean(0)`` (a sum over the pod
    dimension divided by its size).  The update computed from it is the
    one every pod pulls."""
    return tree_map(lambda g: g.float().sum(0) / g.shape[0], grads)


def sync_local(grads):
    """``local_sgd`` sends no gradients: each pod keeps its own."""
    return grads


def sync_hier(grads, *, num_channels: int = 4):
    """Channel-striped cross-pod mean: each leaf with a leading dim >= 2 is
    reduced in ``num_channels`` slices of that dim, then concatenated."""

    def one(g):
        g, n = g.float(), g.shape[0]
        if g.dim() == 1 or g.shape[1] < 2:
            return g.sum(0) / n
        parts = [
            g[:, s : s + size].sum(0) for s, size in _chunk_bounds(g.shape[1], num_channels)
        ]
        return torch.cat(parts, dim=0) / n

    return tree_map(one, grads)


def sync_hier_int8(grads, ef):
    """int8 + error feedback on the WAN hop.

    g' = g + ef; q = quant(g') for every pod at once (one ``wan_quant``
    launch per leaf); the stacked int8 payloads and scales are what the
    all-gather would deliver, so one ``wan_dequant`` launch per leaf gives
    every pod's dequantised gradient; the synced gradient is their mean, and
    each pod's new ef is g' minus its own slice.
    Returns (synced grads, new ef [npods, ...], WAN bytes each pod sends:
    its int8 payload and float32 scales to each of the npods - 1 others).
    """
    boosted = apply_error_feedback(grads, ef)
    payload = 0

    def one(g):
        nonlocal payload
        n = g.shape[0]
        c = int8_compress(g.reshape(n, 1) if g.dim() == 1 else g)  # a 0-d leaf is one lane
        deq = int8_decompress(c).reshape(g.shape)
        payload += compressed_bytes(c) // n * (n - 1)
        return deq

    transmitted = tree_map(one, boosted)
    synced = tree_map(lambda d: d.sum(0) / d.shape[0], transmitted)
    return synced, residual(boosted, transmitted), payload


def full_precision_bytes(grads) -> int:
    """WAN bytes each pod sends in a ring all-reduce of the float32 grads."""
    leaves = tree_leaves(grads)
    n = leaves[0].shape[0]
    return int(2 * (n - 1) * sum(g[0].numel() * 4 for g in leaves) // n)


def ps_bytes(grads) -> int:
    """WAN bytes each pod moves under ``ps``: its float32 gradients pushed
    to the server and the float32 parameters pulled back."""
    return int(2 * sum(g[0].numel() * 4 for g in tree_leaves(grads)))


def wan_bytes_per_step(params_size_bytes: int, strategy: str, *, npods: int = 2) -> float:
    """Analytic WAN byte volume per pod per step (for the §Perf table)."""
    if strategy == "allreduce":
        return 2 * (npods - 1) / npods * params_size_bytes
    if strategy == "ps":
        return 2.0 * params_size_bytes  # push grads + pull params
    if strategy == "hier":
        return 2 * (npods - 1) / npods * params_size_bytes
    if strategy == "hier_int8":
        return (npods - 1) * (params_size_bytes / 4 * 1.016)  # int8 + scales
    if strategy == "local_sgd":
        return 0.0
    raise ValueError(strategy)
