"""Trees of DTensors on a pod's ``(data, model)`` mesh, and each leaf's piece of the WAN hop.

Parameters, optimizer state, batch and caches of a rank are DTensors on its
pod's mesh (:func:`repro_torch.launch.mesh.intra_pod_mesh`), placed by
:mod:`.sharding`'s rules with the ``pod`` entry dropped: every pod holds
its own replica, as the JAX step's manual ``"pod"`` axis gives each pod
its own copy.  :func:`place` builds a rank's shard from a full tensor that
every rank holds (a seeded init, a restored checkpoint, the loader's global
batch) by slicing it locally, as ``torch.chunk`` splits (DTensor's rule),
so placing moves no bytes.

The WAN hop runs on pieces (:func:`to_piece` / :func:`from_piece`): every
leaf's dim 0 is split over the pod's ranks, data-major, so that the pod's
ranks hand the WAN each element of a leaf once, whatever its placement
(a leaf replicated over ``data`` or ``model`` would otherwise cross the WAN
once per replica), and a piece keeps its last dim whole, so the int8
quantiser's 256-lane blocks run along the global last dim and a piece's
payload is the global array's, bit for bit.  A leaf of rank 0 or 1 is one
row: the pod's first rank carries it whole.  The moves between a leaf's
placement and its pieces are intra-pod (LAN) traffic.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..device import has_values
from ..tree import tree_map


def _dtensor():
    from torch.distributed.tensor import DTensor

    return DTensor


def is_dtensor(t) -> bool:
    return isinstance(t, _dtensor())


def contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def drop_pod(placements, mesh_axes) -> tuple:
    """A full mesh's placements without the ``pod`` entry."""
    return tuple(p for a, p in zip(mesh_axes, placements) if a != "pod")


def place(t: torch.Tensor, mesh, placements):
    """The rank's shard of full tensor ``t`` (the same on every rank) as a
    DTensor on ``mesh`` with ``placements``, sliced locally: each
    ``Shard`` cuts as ``torch.chunk`` does, in mesh order; a
    ``_StridedShard`` on mesh dim i with a ``Shard`` of the same dim on a
    later mesh dim j is one dim over (j, i), j-major (the few-expert
    ``("model", "data")`` rule): the piece ``coord[j] * size[i] + coord[i]``."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    coord = mesh.get_coordinate()
    local = t
    for i, p in enumerate(placements):
        if isinstance(p, _StridedShard):
            j = next((k for k in range(i + 1, len(placements))
                      if type(placements[k]) is Shard and placements[k].dim == p.dim), None)
            if j is None or p.split_factor != mesh.size(j):
                raise NotImplementedError(f"placing a tensor by {tuple(placements)}")
            n = mesh.size(i) * mesh.size(j)
            local = local.chunk(n, dim=p.dim)[coord[j] * mesh.size(i) + coord[i]]
        elif type(p) is Shard:
            if any(isinstance(q, _StridedShard) and q.dim == p.dim for q in placements[:i]):
                continue  # cut with its strided partner above
            chunks = local.chunk(mesh.size(i), dim=p.dim)
            local = chunks[coord[i]] if coord[i] < len(chunks) else local.narrow(p.dim, 0, 0)
    local = local.contiguous()
    if local.numel() < t.numel() and (not has_values(t) or
                                      local.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()):
        local = local.clone()  # a view of a shard would keep the whole tensor alive (a fake one has no address)
    return _dtensor().from_local(local, mesh, tuple(placements), run_check=False,
                                 shape=t.shape, stride=contiguous_stride(t.shape))


def place_tree(tree, mesh, placements_tree):
    """:func:`place` at every leaf of ``tree`` (placements a matching tree of tuples)."""
    if isinstance(tree, dict):
        return {k: place_tree(v, mesh, placements_tree[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [place_tree(v, mesh, p) for v, p in zip(tree, placements_tree)]
    return place(tree, mesh, placements_tree)


def full(t):
    """The whole tensor of a DTensor (a gather over its mesh); a plain
    tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def full_tree(tree):
    return tree_map(full, tree)


# -- the WAN hop's pieces ----------------------------------------------------------


def _piece_placements(t):
    from torch.distributed.tensor import Replicate, Shard

    n = t.device_mesh.ndim
    return (Shard(0),) * n if t.ndim >= 2 else (Replicate(),) * n


def _owns_row(mesh) -> bool:
    return all(c == 0 for c in mesh.get_coordinate())


def to_piece(t) -> torch.Tensor:
    """The rank's piece of DTensor leaf ``t``: dim 0 split over the pod's
    ranks (possibly empty); a rank-0/1 leaf whole on the pod's first rank,
    empty elsewhere.  A contiguous plain tensor."""
    mesh = t.device_mesh
    local = t.redistribute(mesh, _piece_placements(t)).to_local()
    if t.ndim < 2 and not _owns_row(mesh):
        local = local.new_empty((0,))
    return local.contiguous()


def from_piece(piece: torch.Tensor, like):
    """The DTensor placed as ``like`` whose pieces (:func:`to_piece`) are
    the ranks' ``piece``."""
    from torch.distributed.tensor import Partial

    mesh, DTensor = like.device_mesh, _dtensor()
    if like.ndim >= 2:
        dt = DTensor.from_local(piece, mesh, _piece_placements(like), run_check=False,
                                shape=like.shape, stride=contiguous_stride(like.shape))
    else:  # the first rank's row, zeros on the others, summed
        whole = piece if piece.numel() or math.prod(like.shape) == 0 else None
        if whole is None:
            whole = torch.zeros(like.shape, dtype=piece.dtype, device=piece.device)
        dt = DTensor.from_local(whole.reshape(like.shape), mesh, (Partial(),) * mesh.ndim, run_check=False,
                                shape=like.shape, stride=contiguous_stride(like.shape))
    return dt.redistribute(mesh, like.placements)
