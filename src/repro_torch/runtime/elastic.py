"""Elastic re-meshing: survive pod loss, absorb pod joins.

Port of ``repro.runtime.elastic``: when the failure detector kills a pod,
:func:`plan_remesh` picks the new mesh (drop the pod axis or shrink it),
:meth:`MeshPlan.build` makes it over the ranks that survive, and
:func:`reshard_tree` re-places the restored checkpoint on it by the
sharding rules.  :class:`ElasticCoordinator` tracks pod membership and
records each plan.  Parameters are pod-replicated, so any surviving pod
holds a complete model copy: re-meshing is a resharding, never a data
loss.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    npods: int
    note: str

    def build(self, *, ranks: Optional[Sequence[int]] = None, device="cuda"):
        """The planned mesh (:func:`repro_torch.launch.mesh.make_mesh`).  In a
        started process group every rank of the old world calls this, as
        making the new groups needs: the mesh spans ``ranks`` (by default
        the first ranks of the world, pod-major: the pods kept are the
        first ones), and a rank outside them, whose pod was lost, gets None
        and leaves.  In one process, a ``LocalMesh``."""
        import torch.distributed as dist

        from ..launch.mesh import make_mesh

        if ranks is None and dist.is_available() and dist.is_initialized():
            size = 1
            for s in self.shape:
                size *= s
            ranks = range(size)
        return make_mesh(self.shape, self.axes, device=device, ranks=ranks)

    def to_dict(self) -> dict:
        return {
            "shape": list(self.shape),
            "axes": list(self.axes),
            "npods": self.npods,
            "note": self.note,
        }


def plan_remesh(
    current_pods: int,
    surviving_pods: int,
    *,
    data: int,
    model: int,
) -> MeshPlan:
    """New mesh after pod loss/join.

    2 -> 1 pods collapses the pod axis (single-DC operation); N -> M keeps
    a pod axis of M.  The data/model factors within a pod are unchanged:
    intra-pod topology didn't change, only the WAN peer set did.
    """
    if surviving_pods < 1:
        raise ValueError("no survivors")
    if surviving_pods == 1:
        return MeshPlan(
            shape=(data, model), axes=("data", "model"), npods=1,
            note=f"collapsed pod axis ({current_pods}->1); WAN sync disabled",
        )
    return MeshPlan(
        shape=(surviving_pods, data, model),
        axes=("pod", "data", "model"),
        npods=surviving_pods,
        note=f"pod axis {current_pods}->{surviving_pods}",
    )


def reshard_tree(tree, new_mesh):
    """Re-place a parameter tree onto ``new_mesh`` by the rules
    (:func:`repro_torch.distributed.sharding.params_placements`): its
    leaves are full tensors (as restored from a checkpoint) or DTensors on
    the old mesh, which are gathered over their own pod first.  On a mesh
    whose pods are single ranks, or in one process, the leaves come back
    whole."""
    from ..distributed.lan import LanCollectives
    from ..distributed.placement import full, is_dtensor, place_tree
    from ..distributed.sharding import params_placements
    from ..distributed.steps import intra_placements
    from ..launch.mesh import intra_pod_mesh
    from ..tree import tree_leaves, tree_map

    placed = [t for t in tree_leaves(tree) if is_dtensor(t)]
    if placed:
        with LanCollectives(placed[0].to_local().device):
            tree = tree_map(full, tree)
    intra = intra_pod_mesh(new_mesh)
    if intra is None:
        return tree
    return place_tree(tree, intra, intra_placements(params_placements(tree, new_mesh), new_mesh))


@dataclasses.dataclass
class ElasticEvent:
    step: int
    kind: str  # "pod_lost" | "pod_joined"
    pod: str
    plan: MeshPlan


class ElasticCoordinator:
    """Tracks pod membership and produces re-mesh plans on change."""

    def __init__(self, pods: List[str], *, data: int, model: int):
        self.pods = list(pods)
        self.data = data
        self.model = model
        self.events: List[ElasticEvent] = []

    def on_pod_lost(self, pod: str, step: int) -> MeshPlan:
        if pod in self.pods:
            self.pods.remove(pod)
        plan = plan_remesh(
            len(self.pods) + 1, len(self.pods), data=self.data, model=self.model
        )
        self.events.append(ElasticEvent(step=step, kind="pod_lost", pod=pod, plan=plan))
        return plan

    def on_pod_joined(self, pod: str, step: int) -> MeshPlan:
        if pod not in self.pods:
            self.pods.append(pod)
        plan = plan_remesh(
            len(self.pods) - 1, len(self.pods), data=self.data, model=self.model
        )
        self.events.append(ElasticEvent(step=step, kind="pod_joined", pod=pod, plan=plan))
        return plan
