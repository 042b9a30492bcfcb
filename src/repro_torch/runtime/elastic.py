"""Elastic re-meshing: survive pod loss, absorb pod joins.

Port of ``repro.runtime.elastic``'s planning half, as plain Python: when the
failure detector kills a pod, :func:`plan_remesh` picks the new mesh (drop
the pod axis or shrink it), and :class:`ElasticCoordinator` tracks pod
membership and records each plan.  Parameters are pod-replicated, so any
surviving pod holds a complete model copy: re-meshing is a resharding,
never a data loss.  Building the mesh and re-placing a tree on it need a
``DeviceMesh`` / DTensor placement, which is not ported yet (ROADMAP
queue 1, item 16): :meth:`MeshPlan.build` and :func:`reshard_tree` raise.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

PLACEMENT_NOT_PORTED = (
    "device meshes and resharding are not ported to repro_torch yet "
    "(ROADMAP queue 1, item 16: a DeviceMesh and DTensor placements)"
)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    npods: int
    note: str

    def build(self):
        raise NotImplementedError(PLACEMENT_NOT_PORTED)

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
    raise NotImplementedError(PLACEMENT_NOT_PORTED)


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
