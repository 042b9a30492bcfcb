"""Cross-pod (inter-data-center) gradient synchronisation.

Port of ``repro.distributed.sync``.  The JAX functions run inside
``shard_map`` with a manual ``"pod"`` axis.  The port has two forms of
each strategy:

* stacked, in one process: the pod axis is the LEADING dimension of every
  gradient leaf, ``[npods, ...]``; a ``psum`` over pods becomes a sum over
  that dimension, and the all-gather of the int8 payloads is the stacked
  tensor itself.  Each function computes what its JAX counterpart
  computes under ``jax.vmap(..., axis_name="pod")``; the synced gradient,
  identical on every pod there, is returned once;
* group (``*_group``), one rank per pod: each rank holds its own leaves,
  as the JAX function sees them inside its ``"pod"`` shard, and the
  strategy runs as collectives of a
  :class:`~repro_torch.distributed.pod_group.PodGroup`.  Sums over
  gathered payloads run in rank order, as the stacked forms sum over
  their leading dimension.

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
    Int8Compressed,
    apply_error_feedback,
    compressed_bytes,
    int8_compress,
    int8_decompress,
    residual,
)
from ..tree import tree_items, tree_leaves, tree_map, tree_unflatten

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


def sync_hier_int8(grads, ef, *, in_place: bool = False):
    """int8 + error feedback on the WAN hop.

    g' = g + ef; q = quant(g') for every pod at once (one ``wan_quant``
    launch per leaf); the stacked int8 payloads and scales are what the
    all-gather would deliver, so one ``wan_dequant`` launch per leaf gives
    every pod's dequantised gradient; the synced gradient is their mean, and
    each pod's new ef is g' minus its own slice.
    Returns (synced grads, new ef [npods, ...], WAN bytes each pod sends:
    its int8 payload and float32 scales to each of the npods - 1 others).
    A leaf at a time: g' and its dequantised copy live for one leaf only,
    and g' becomes the new ef in place (recurrentgemma-9b's stacked 2-pod
    embedding gradient is 7.8 GiB).  ``in_place``: g' is formed in ef's own
    storage (a donating step's), so the new ef takes no memory of its own,
    and the gradients are donated too: each leaf's storage is freed once
    it is folded into ef (mixtral-8x22b's stacked 2-pod expert gradients
    are 3.2 GB a leaf).
    """
    payload, synced, new_ef = 0, [], []
    for (_, g), (_, e) in zip(tree_items(grads), tree_items(ef)):
        if in_place:  # apply_error_feedback, one leaf
            storage = g.untyped_storage()
            if g.storage_offset() or storage.nbytes() != g.numel() * g.element_size():
                raise ValueError("sync_hier_int8(in_place=True) frees each gradient leaf's storage: "
                                 "a leaf must own its whole storage, not be a view into a larger one")
            boosted = e.add_(g)
            storage.resize_(0)
        else:
            boosted = g.float() + e
        n = boosted.shape[0]
        c = int8_compress(boosted.reshape(n, 1) if boosted.dim() == 1 else boosted)  # a 0-d leaf is one lane
        deq = int8_decompress(c).reshape(boosted.shape)
        payload += compressed_bytes(c) // n * (n - 1)
        synced.append(deq.sum(0).div_(n))
        new_ef.append(boosted.sub_(deq.float()))  # residual, one leaf, in the storage of g'
        del c, deq
    return tree_unflatten(grads, synced), tree_unflatten(ef, new_ef), payload


# -- group forms: one rank per pod --------------------------------------------------


def sync_allreduce_group(grads, group):
    """Flat cross-pod mean: one ``all_reduce`` SUM per leaf, then / n."""
    return tree_map(lambda g: group.all_reduce(g.to(torch.float32, copy=True)) / group.size, grads)


def sync_ps_group(grads, group):
    """The parameter server's average of the pushed float32 gradients: the
    ``all_gather`` of each leaf (the push), summed in rank order / n."""
    return tree_map(lambda g: group.all_gather(g.float()).sum(0) / group.size, grads)


def pull_params_group(params, group):
    """The pull: rank 0's parameters on every pod, broadcast as float32."""

    def one(p):
        return group.broadcast(p.to(torch.float32, copy=True)).to(p.dtype)

    return tree_map(one, params)


def sync_hier_group(grads, group, *, num_channels: int = 4):
    """Channel-striped cross-pod mean: a leaf with a leading dim >= 2 is
    reduced by one ``all_reduce`` per slice of that dim (§3.3 striping),
    in place in one float32 buffer."""

    def one(g):
        g = g.to(torch.float32, copy=True)
        if g.dim() == 0 or g.shape[0] < 2:
            return group.all_reduce(g) / group.size
        for s, size in _chunk_bounds(g.shape[0], num_channels):
            group.all_reduce(g[s : s + size])
        return g / group.size

    return tree_map(one, grads)


def sync_hier_int8_group(grads, ef, group):
    """int8 + error feedback on the WAN hop, one rank per pod.

    g' = g + ef; ``wan_quant`` of the rank's own leaf; ``all_gather`` of
    its int8 payload and of its float32 scales; one ``wan_dequant`` launch
    over all the gathered payloads of the leaf; their sum in rank order,
    / n; the new ef is g' minus the rank's own dequantised payload.
    Returns (synced grads, new ef)."""
    boosted = apply_error_feedback(grads, ef)
    n, rank = group.size, group.rank

    def one(g):
        c = int8_compress(g)
        gathered = Int8Compressed(
            values=group.all_gather(c.values), scales=group.all_gather(c.scales),
            orig_last=c.orig_last, orig_shape=(n, *c.orig_shape),
        )
        deq = int8_decompress(gathered)
        return deq.sum(0) / n, deq[rank]

    out = tree_map(one, boosted)
    synced = tree_map(lambda _, pair: pair[0], boosted, out)
    transmitted = tree_map(lambda _, pair: pair[1], boosted, out)
    return synced, residual(boosted, transmitted)


def group_wan_bytes(strategy: str, handed, npods: int) -> int:
    """The WAN bytes each pod sends this step under ``strategy``, from the
    bytes handed to each collective (``PodGroup.handed``): a ring
    all-reduce sends 2 (n - 1) / n of what it is handed; the int8 payload
    goes to each of the n - 1 other pods; the parameter server's push is
    the pod's gradients once and its pull the parameters once.  These
    equal :func:`full_precision_bytes`, the stacked ``hier_int8`` payload
    and :func:`ps_bytes` of the same leaves."""
    if strategy in ("allreduce", "hier", "local_sgd"):
        return int(2 * (npods - 1) * handed["all_reduce"] // npods)
    if strategy == "hier_int8":
        return int((npods - 1) * handed["all_gather"])
    if strategy == "ps":
        return int(handed["all_gather"] + handed["broadcast"])
    raise ValueError(strategy)


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
