"""Collective bytes of a traced step: by kind, and the share that crosses pods.

The port's counterpart of ``repro.launch.hlo_stats``.  The JAX dry run
parses the compiled HLO for collective instructions; the port runs eagerly,
so the counts come from the collectives its step actually issues while the
dry run traces it (:mod:`repro_torch.launch.dryrun`): the ``c10d`` calls
that :class:`~repro_torch.distributed.lan.LanCollectives` makes of DTensor's
functional collectives (the FSDP all-gathers, the gradients'
reduce-scatters, the partial sums' all-reduces) and those of
:class:`~repro_torch.distributed.pod_group.PodGroup` over the pod axis (the
WAN strategies), and any functional collective that runs outside such a
mode.  Under the dry run they are counted only: the process group is a fake
one and the tensors are fake, so nothing moves and nothing is timed.

Bytes follow the JAX file's rule: each collective counts its **result**, as
one device sees it (an all-gather ``group_size`` times what it was handed,
a reduce-scatter ``1 / group_size`` of it, an all-reduce or broadcast what
it was handed).  ``LanCollectives.handed`` and ``PodGroup.handed`` count the
tensor handed to each call instead, which is what the WAN strategies'
:func:`repro_torch.distributed.sync.group_wan_bytes` reads; for a two-pod
``hier`` or ``allreduce`` step the two agree on the WAN all-reduce.

Cross-pod classification follows the rank layout :mod:`.mesh` shares with
the JAX package: pod-major, so a rank's pod is ``rank // ranks_per_pod``,
and a collective whose group holds ranks of two pods is WAN traffic.

``scan_trip_counts`` has no counterpart: the port loops over its layer
groups in Python, so every group's collectives are issued, and counted,
one by one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten

#: a collective op's name (``c10d`` or functional) -> its kind, in the HLO's words
_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce", "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce", "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather", "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather", "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter", "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all", "all_to_all_single": "all-to-all",
    "broadcast_": "broadcast", "broadcast": "broadcast",
    "send": "collective-permute", "recv_": "collective-permute",
}
_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of a tensor's elements (its shape times its element size):
    the counterpart of ``hlo_stats.shape_bytes``."""
    return t.numel() * t.element_size()


@dataclass
class CollectiveStats:
    #: per-op-kind total result bytes (one device's view)
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    #: bytes on collectives whose groups span pods (WAN)
    cross_pod_bytes: int = 0
    #: bytes on collectives we could not classify
    unclassified_bytes: int = 0
    count: int = 0
    #: "kind dtype [result shape]" -> [calls, result bytes]: which tensors move
    by_shape: Dict[str, List[int]] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, nbytes: int, crosses: Optional[bool], shape: str = "") -> None:
        """One collective of ``kind`` with ``nbytes`` of result (of ``shape``,
        its first result's dtype and shape); ``crosses``: whether its group
        spans pods (None: unknown, only counted where pods are classified
        at all)."""
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes
        self.count += 1
        calls = self.by_shape.setdefault(f"{kind} {shape}".strip(), [0, 0])
        calls[0] += 1
        calls[1] += nbytes
        if crosses is None:
            self.unclassified_bytes += nbytes
        elif crosses:
            self.cross_pod_bytes += nbytes


def collective_kind(func) -> Optional[str]:
    """The kind of a dispatched op if it is a collective, else None; a
    ``wait_tensor`` is not one (its collective was counted)."""
    if getattr(func, "namespace", None) not in _NAMESPACES:
        return None
    return _KINDS.get(func._opname)


def _group_ranks(args, kwargs):
    """The global ranks of the process group among a collective's arguments
    (a ``ProcessGroup`` for the ``c10d`` ops, a group name for the
    functional ones), or None."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    unbox = torch._C._distributed_c10d.ProcessGroup.unbox
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.get_process_group_ranks(unbox(a))
            except (RuntimeError, TypeError, ValueError):
                continue  # a ReduceOp, not the group
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, str):
            try:
                return dist.get_process_group_ranks(_resolve_process_group(a))
            except (RuntimeError, ValueError, KeyError):
                continue
    return None


def record(stats: CollectiveStats, func, args, kwargs, out, *, pod_size: int) -> bool:
    """Count ``func`` in ``stats`` if it is a collective (its result: the
    tensors it returns) and say whether it was.  ``pod_size``: ranks per
    pod, 0 where the mesh has no pod axis (nothing is classified)."""
    kind = collective_kind(func)
    if kind is None:
        return False
    results = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
    nbytes = sum(tensor_bytes(t) for t in results)
    shape = f"{str(results[0].dtype).replace('torch.', '')} {list(results[0].shape)}" if results else ""
    if len(results) > 1:
        shape += f" x{len(results)}"
    crosses: Optional[bool] = False
    if pod_size:
        ranks = _group_ranks(args, kwargs or {})
        crosses = None if not ranks else min(ranks) // pod_size != max(ranks) // pod_size
    stats.add(kind, nbytes, crosses, shape)
    return True
